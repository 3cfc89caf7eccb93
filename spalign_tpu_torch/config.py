"""Typed configuration of the label-generation, training and
self-training paths.

The port's own copy of the dataclasses of ``spalign_tpu/config.py``
(same fields, defaults and validation), so that neither package imports
the other.  ``flatten`` embeds the active config into every result
record, as the reference does with ``vars(args)``; ``to_json`` writes
the rounds driver's ``rounds_args.txt``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PriorConfig:
    """Gaussian road-location prior (reference batch_spalign_kmeans.py:111-129).

    weights = exp(-((y - int(H*y_rel_pos))^2 / (2*H*y_rel_sigma)^2
                    + (x - int(W*x_rel_pos))^2 / (2*W*x_rel_sigma)^2))

    The reference divides by ``(2*sigma)**2``, not ``2*sigma**2``; the
    port reproduces that exactly.
    """

    y_rel_pos: float = 0.75
    x_rel_pos: float = 0.5
    y_rel_sigma: float = 0.1
    x_rel_sigma: float = 0.1


@dataclass(frozen=True)
class SuperpixelConfig:
    """Superpixel frontend (reference batch_spalign_kmeans.py:299-313).

    ``method='felzenszwalb'`` runs the native host op (the reference's
    headline configuration); ``method='slic'`` runs SLIC on the device,
    then the host connectivity pass unless
    ``slic_enforce_connectivity=False`` (``pipeline/superpixels.py``).
    """

    method: str = "felzenszwalb"  # 'felzenszwalb' | 'slic'
    felzenszwalb_scale: float = 300.0
    felzenszwalb_sigma: float = 0.8
    felzenszwalb_min_size: int = 20
    n_slic_segments: int = 100
    slic_compactness: float = 10.0
    slic_iters: int = 10
    # skimage-parity connectivity pass on the host; False runs SLIC on
    # the device inside the label program (labels may be disconnected)
    slic_enforce_connectivity: bool = True
    # device SLIC at 1/d of the network resolution (1 = full resolution)
    slic_device_downscale: int = 1
    # padding bound for the per-image superpixel count (host engines)
    max_superpixels: int = 1024


@dataclass(frozen=True)
class AlignConfig:
    """Superpixel-align pooling (reference batch_spalign_kmeans.py:210-276)."""

    n_anchors: int = 10
    # the reference's 4 nearest cells are the enclosing 2x2 bilinear
    # cell, the only value its scripts use; others are rejected
    n_neighbors: int = 4
    append_pos: bool = True  # append the superpixel centre of mass (y, x)

    def __post_init__(self):
        if self.n_neighbors != 4:
            raise ValueError(
                f"n_neighbors={self.n_neighbors} is not supported: the "
                "4-nearest-cells rule of the reference is implemented as "
                "its closed-form 2x2 bilinear equivalent (ops/align.py), "
                "which only exists for n_neighbors=4")


@dataclass(frozen=True)
class KMeansConfig:
    """Prior-seeded weighted k-means (reference batch_spalign_kmeans.py:136-207)."""

    n_clusters: int = 4
    n_iter: int = 1000
    seed: int = 1111
    # full re-runs when an image ends up with an empty road mask
    max_retries: int = 3
    # 'device': seeded on the device from the host seed stream;
    # 'reference': the bit-parity mode, the reference's own numpy and
    # python streams replayed on the host (ops/parity.py), DRN in float32
    init: str = "device"

    def __post_init__(self):
        if self.init not in ("device", "reference"):
            raise ValueError(f"init must be 'device' or 'reference', "
                             f"got {self.init!r}")


@dataclass(frozen=True)
class LabelGenConfig:
    """Label-generation pipeline config (reference batch_spalign_kmeans.py
    CLI :38-108)."""

    mode: str = "spalign"  # 'spalign' | 'direct' | 'overlaps'
    resize_shape: Tuple[int, int] = (224, 224)  # (H, W) model input
    batchsize: int = 30  # joint-clustering batch
    use_feature_maps: Tuple[int, ...] = (7,)  # DRN stage outputs to concat
    prior: PriorConfig = field(default_factory=PriorConfig)
    superpixel: SuperpixelConfig = field(default_factory=SuperpixelConfig)
    align: AlignConfig = field(default_factory=AlignConfig)
    kmeans: KMeansConfig = field(default_factory=KMeansConfig)
    overlap_threshold: float = 0.01
    # independent clustering batches run together in one unit
    groups_per_dispatch: int = 1
    out_dir: str = "results/labels"
    save_images: bool = False
    save_masks: bool = True
    # feature-extractor compute dtype; k-means always runs in float32
    model_dtype: str = "bfloat16"  # 'float32' | 'bfloat16'
    upload_format: str = "rgb8"  # 'rgb8' | 'yuv420'

    def __post_init__(self):
        sp = self.superpixel
        if sp.slic_device_downscale > 1:
            d = sp.slic_device_downscale
            device_slic = (sp.method == "slic"
                           and not sp.slic_enforce_connectivity)
            fused_spalign = (self.mode == "spalign" and device_slic
                             and self.kmeans.init == "device")
            if not (device_slic
                    and (self.mode == "overlaps" or fused_spalign)):
                raise ValueError(
                    "slic_device_downscale > 1 applies only to the "
                    "device-SLIC frontends: mode='overlaps' or "
                    "mode='spalign' with kmeans.init='device', both "
                    "with superpixel method='slic' and "
                    "slic_enforce_connectivity=False; got "
                    f"mode={self.mode!r}, method={sp.method!r}, "
                    f"slic_enforce_connectivity="
                    f"{sp.slic_enforce_connectivity}, "
                    f"kmeans.init={self.kmeans.init!r}")
            if fused_spalign and (self.resize_shape[0] % d
                                  or self.resize_shape[1] % d):
                raise ValueError(
                    f"slic_device_downscale={d} must divide "
                    f"resize_shape={self.resize_shape}")


@dataclass(frozen=True)
class TrainConfig:
    """SegNet training config (reference train_segnet.py:41-94)."""

    model: str = "basic"  # 'basic' | 'normal'
    n_class: int = 2
    batchsize: int = 8  # GLOBAL batch (reference: per-rank 1 x 8 ranks)
    lr: float = 0.01
    decay_iteration: int = 300  # lr *= 0.1 every N iters (MomentumSGD only)
    weight_decay: float = 0.0005
    train_iters: int = 2000
    optimizer: str = "Adam"  # 'Adam' | 'MomentumSGD'
    input_shape: Tuple[int, int] = (512, 1024)
    eval_shape: Tuple[int, int] = (1024, 2048)
    augment: bool = False  # PCA lighting + horizontal flip
    log_interval: int = 50
    val_interval: int = 100
    loss: str = "ce"  # 'ce' | 'soft' | 'mse'
    n_use_data: Optional[int] = None
    seed: int = 0
    result_dir: str = "results/train"
    resume: Optional[str] = None
    # data-parallel ranks (torchrun processes); None = the process
    # group's world size, 1 without a group
    num_devices: Optional[int] = None
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class RoundsConfig:
    """Self-training rounds (reference utils/run_train_rounds.py:26-67)."""

    n_round: int = 1
    iteration: int = 2000
    val_iteration: int = 100
    loss: str = "ce"
    augment: bool = False
    test_mode: bool = False
    batchsize: int = 8
    result_base_dir: str = "results"
    eval_shape: Tuple[int, int] = (1024, 2048)
    n_labels: Optional[int] = None  # inferred from dataset if None
    # stored dtype of the soft relabel scores; the reference writes
    # float32 (labels_from_segnet.py:86-95): set "float32" for disk
    # parity.  Softmax probabilities quantize to ~1e-4 in float16.
    score_dtype: str = "float16"
    # resolution of the stored *_scores members: "network" keeps the
    # network output resolution (the training reader resizes scores to
    # the input shape anyway, data/estimated.py); "eval" is the
    # reference's eval-resolution disk format.  PRED members are the same.
    score_store: str = "network"
    # relabel image wire (selftrain/relabel.py): "auto" ships uint8
    # pixels when the dataset's standardization inverts exactly;
    # "yuv420" is lossy and opt-in
    input_wire: str = "auto"


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True,
                      default=str)


def flatten(cfg, prefix: str = "") -> dict:
    """Flatten a (possibly nested) config dataclass into a flat dict for
    result records (reference: ``result_info.update(vars(args))``)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, prefix=f"{f.name}."))
        elif isinstance(v, tuple):
            out[key] = list(v)
        else:
            out[key] = v
    return out
