"""Label generation: the shared host loop and the spalign mode.

Counterpart of ``spalign_tpu/pipeline/label_gen.py``.
``LabelGeneratorBase`` is the host loop the three modes share (a
producer thread that loads and uploads units ahead, ``in_flight`` units
dispatched before the oldest is finished, scoring against full-resolution
labelIds with the native scorer, ``.npy`` mask saving (plus a PNG of
each mask without ground truth), resume); the
direct and overlaps modes live in ``pipeline/direct.py``.
``SpalignLabelGenerator`` runs, for each unit of G clustering groups of
``batchsize`` images, on one device:

    wire -> decode -> superpixels -> DRN features -> superpixel-align
      -> prior -> per-group weighted k-means -> paint -> bit-packed masks

then on the host the bounded retry when a road mask comes out empty.
The superpixels come from one of two frontends:

- the device SLIC frontend (``method='slic'`` without the connectivity
  pass, ``kmeans.init='device'``): SLIC (CUDA kernel) inside the unit's
  program, after an optional d x d box mean; K is the SLIC grid size;
- the host engines (felzenszwalb, SLIC with the connectivity pass, and
  every engine under the parity mode): ``compute_superpixels`` on the
  producer thread, the maps uploaded narrowed; K is
  ``max_superpixels``, the padding bound.

Random draws (anchor bits and the k-means seeding uniforms) come from a
``torch.Generator`` seeded per group from the host seed stream, or are
passed in (``UnitDraws``) so that tests can hand the port the JAX
package's draws.  The bit-parity mode (``kmeans.init='reference'``)
replays the reference's own streams instead: the anchor shuffle, align
and float64 prior on the host (``ops/parity.py``), the seed-1111 numpy
init, then the Lloyd loop and painting on the device.

A sweep reuses one generator: ``reconfigure`` adopts a new config
(``set_n_clusters`` a new k) and keeps the weights and the seed streams,
so the sweep's rows consume one host seed stream in order, as the JAX
package's do.  k is read from the config at each dispatch: nothing is
compiled or shaped by it, and ``dynamic_k`` is only the bound that k
may not pass (the JAX package compiles its k-means for up to that many
clusters).

Not ported yet: diagnostic panels (``save_images``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.config import LabelGenConfig, flatten
from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.eval.results import ResultWriter
from spalign_tpu_torch.kernels.slic import slic, slic_grid_size
from spalign_tpu_torch.models.drn import DRN_FACTORIES, preprocess_imagenet
from spalign_tpu_torch.ops.align import superpixel_align
from spalign_tpu_torch.ops.kmeans import (paint_clusters, weighted_kmeans,
                                          weighted_kmeans_from_init)
from spalign_tpu_torch.ops.parity import (reference_seed_assignment,
                                          reference_superpixel_align,
                                          superpixel_prior_host)
from spalign_tpu_torch.ops.prior import superpixel_prior
from spalign_tpu_torch.ops.segments import anchor_key_bits
from spalign_tpu_torch.pipeline.superpixels import compute_superpixels
from spalign_tpu_torch.pipeline.wire import decode_yuv420
from spalign_tpu_torch.utils.device import resolve_device
from spalign_tpu_torch.utils.timers import StageTimer

# k-means sweeps between the host's checks whether every group stopped
# (one device sync each); the results do not depend on it
KMEANS_CHECK_EVERY = 16


class UnitDraws(NamedTuple):
    """Explicit random draws of one unit of G groups of b images.

    anchor_bits: (G*b, H*W) integers in [0, 2**anchor_key_bits(S)), one
      row per image, in image order.
    uniforms: (G, b*S) float in [0, 1), the seeding shuffle per group.
    """

    anchor_bits: torch.Tensor
    uniforms: torch.Tensor


def _align_and_prior(feature_maps, superpixels, n_anchors, s, append_pos,
                     prior_params, pos_scale, anchor_bits):
    """Per-superpixel aligned features + segment-mean prior of a batch:
    (feats (B, S, C'), valid (B, S), prior (B, S))."""
    feats, valid = superpixel_align(
        feature_maps, superpixels, n_anchors, s, append_pos=append_pos,
        pos_scale=pos_scale, random_bits=anchor_bits)
    prior = superpixel_prior(superpixels, s, *prior_params)
    return feats, valid, prior


def cluster_groups(feature_maps: torch.Tensor, superpixels: torch.Tensor,
                   draws: UnitDraws, *, n_groups: int, n_anchors: int,
                   num_segments: int, append_pos: bool, k: int,
                   n_iter: int, prior_params, pos_scale: float = 1.0):
    """Align + prior + weighted k-means + painting of G independent
    clustering groups (the images split in order into G groups of
    B // G); each group clusters jointly and stops on its own.

    Returns road_masks (B, H, W) bool, cluster_maps (B, H, W) int32,
    assignment (B, S) int32, the per-group KMeansResult, and ok (G,)
    bool: every image of the group has a non-empty road mask."""
    n = superpixels.shape[0]
    g, s = n_groups, num_segments
    b = n // g
    superpixels = superpixels.to(torch.int32)
    feats, valid, prior = _align_and_prior(
        feature_maps, superpixels, n_anchors, s, append_pos, prior_params,
        pos_scale, draws.anchor_bits)
    res = weighted_kmeans(feats.reshape(g, b * s, -1), prior.reshape(g, -1),
                          valid.reshape(g, -1), k=k, n_iter=n_iter,
                          uniforms=draws.uniforms,
                          check_every=KMEANS_CHECK_EVERY)
    assign = res.assignment.reshape(n, s)
    cluster = paint_clusters(superpixels, assign)
    road = cluster == 0
    ok = road.flatten(1).any(1).reshape(g, b).all(1)
    return road, cluster, assign, res, ok


def spalign_cluster(feature_maps: torch.Tensor, superpixels: torch.Tensor,
                    draws: UnitDraws, *, n_anchors: int, num_segments: int,
                    append_pos: bool, k: int, n_iter: int, prior_params,
                    pos_scale: float = 1.0):
    """One clustering group (``cluster_groups`` with G = 1): road_masks,
    cluster_maps, assignment and the KMeansResult of the group."""
    road, cluster, assign, res, _ = cluster_groups(
        feature_maps, superpixels, draws, n_groups=1, n_anchors=n_anchors,
        num_segments=num_segments, append_pos=append_pos, k=k,
        n_iter=n_iter, prior_params=prior_params, pos_scale=pos_scale)
    return road, cluster, assign, res


def draw_unit(seeds: Sequence[int], images_per_group: int, hw: int,
              num_segments: int, device) -> UnitDraws:
    """The port's own draws: one generator per group, seeded with the
    group's host seed, draws the group's anchor bits, then its
    uniforms."""
    avail = anchor_key_bits(num_segments)
    bits, unif = [], []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        bits.append(torch.randint(0, 2 ** avail, (images_per_group, hw),
                                  generator=gen, device=device))
        unif.append(torch.rand((images_per_group * num_segments,),
                               generator=gen, device=device))
    return UnitDraws(torch.cat(bits), torch.stack(unif))


def pack_mask_bits(mask_bool: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., ceil(W/8)) uint8, np.unpackbits bit order."""
    w = mask_bool.shape[-1]
    pad = (-w) % 8
    m = mask_bool.to(torch.int32)
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(*m.shape[:-1], -1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=m.device)
    return (m * weights).sum(-1).to(torch.uint8)


def unpack_mask_bits(packed: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_mask_bits` -> (..., w) bool."""
    return np.unpackbits(packed, axis=-1)[..., :w].astype(bool)


def nn_resize_np(x: np.ndarray, out_hw) -> np.ndarray:
    """cv2.INTER_NEAREST-style resize of the last two dims, with the
    float32 index convention src = floor(dst * (src_len / dst_len)) of
    the JAX package's ``ops/resize.nn_resize_cv2`` and native scorer."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    ys = np.floor(np.arange(oh, dtype=np.float32)
                  * (np.float32(h) / np.float32(oh))).astype(np.int64)
    xs = np.floor(np.arange(ow, dtype=np.float32)
                  * (np.float32(w) / np.float32(ow))).astype(np.int64)
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    return x[..., ys, :][..., :, xs]


# labelIds -> confusion code: void (0..6) -> 0, road (7) -> 2, other -> 1
_CONF_LUT = np.zeros(256, np.uint8)
_CONF_LUT[8:] = 1
_CONF_LUT[7] = 2


def host_confusion(road_mask: np.ndarray,
                   label_ids_full: np.ndarray) -> np.ndarray:
    """(2, 2) int64 confusion conf[gt][pred] of one road mask against
    full-resolution raw Cityscapes labelIds (void ids 0..6 ignored): the
    native one-pass scorer (``native.confusion_vs_labelids``)."""
    return native.confusion_vs_labelids(road_mask, label_ids_full)


def host_confusion_reference(road_mask: np.ndarray,
                             label_ids_full: np.ndarray) -> np.ndarray:
    """Plain numpy version of :func:`host_confusion`: NN-upsample, LUT,
    bincount."""
    h, w = label_ids_full.shape
    pred = road_mask.astype(np.uint8)
    if pred.shape != (h, w):
        pred = nn_resize_np(pred, (h, w))
    idx = _CONF_LUT[label_ids_full] * 2 + pred  # uint8, values 0..5
    c = np.bincount(idx.ravel(), minlength=6)
    return np.array([[c[2], c[3]], [c[4], c[5]]], np.int64)


def _confusion_record(conf) -> dict:
    tp, fp, fn = int(conf[1, 1]), int(conf[0, 1]), int(conf[1, 0])
    tn = int(conf[0, 0])
    road_den = tp + fp + fn
    non_den = tn + fp + fn
    return {
        "road_iou": tp / road_den if road_den else float("nan"),
        "non_road_iou": tn / non_den if non_den else float("nan"),
        "precision": tp / (tp + fp) if tp + fp > 0 else None,
        "recall": tp / (tp + fn) if tp + fn > 0 else None,
        "TP": tp, "FP": fp, "FN": fn,
    }


def _name(dataset, attr, idx):
    fn = getattr(dataset, attr, None)
    return fn(idx) if callable(fn) else f"img_{idx:06d}.png"


def _load_full_images(dataset, indices):
    """(B, H, W, 3) uint8 original-resolution images (the overlaps mode
    computes its superpixels at full resolution)."""
    if hasattr(dataset, "full_images"):
        return np.stack(dataset.full_images(list(indices)))
    return np.stack([np.asarray(dataset[i][0], np.uint8) for i in indices])


def _load_batch(dataset, indices, resize_hw):
    """(B, h, w, 3) uint8 resized images + full-res labelIds (or None)."""
    if hasattr(dataset, "resized_batch"):
        return dataset.resized_batch(list(indices), resize_hw)
    imgs, labels = [], []
    for idx in indices:
        item = dataset[idx]
        img, lab = item if isinstance(item, tuple) else (item, None)
        imgs.append(native.resize_cubic_u8(np.asarray(img, np.uint8),
                                           resize_hw))
        labels.append(lab)
    labels = None if labels[0] is None else np.stack(labels)
    return np.stack(imgs), labels


def fused_superpixels(cfg: LabelGenConfig) -> bool:
    """True when SLIC runs inside the spalign unit's program (the device
    SLIC frontend): method 'slic' without the host connectivity pass,
    and the device init (the parity mode needs the maps on the host)."""
    sp = cfg.superpixel
    return (sp.method == "slic" and not sp.slic_enforce_connectivity
            and cfg.kmeans.init == "device")


def batch_slices(start_index: int, end_index: int, bs: int):
    """Clustering batches of ``bs`` images; the tail batch keeps the
    batchsize by overlapping its predecessor (reference
    batch_spalign_kmeans.py:538-544)."""
    slices = []
    i = start_index
    while i < end_index:
        if i + bs >= end_index and end_index - bs >= 0:
            i = max(start_index, end_index - bs)
            j = end_index
        else:
            j = min(i + bs, end_index)
        slices.append((i, j))
        i = j
    return slices


class LabelGeneratorBase:
    """The host loop the three label-generation modes share.

    Subclasses implement ``dispatch_batch`` (run a unit's device program
    and start its results on the way to the host, under ``"_host"``) and
    ``finish_batch`` (wait for them).  Every mode downloads its road masks
    bit-packed (``road_packed``), at 1/``packed_upscale`` of the mask
    resolution when the mode says so.

    Args:
      cfg: LabelGenConfig of the subclass's mode.
      state_dict: DRN weights (e.g. from ``convert.from_jax`` or a
        ``.pth`` checkpoint); random weights from a fixed seed when None.
      seed: host seed stream of the per-group seeds, and the seed of the
        parity mode's replicas of the reference's numpy and python
        streams (default cfg.kmeans.seed).
      device: 'cuda' (default; raises without CUDA) or 'cpu'.
      dynamic_k: the most clusters ``reconfigure`` / ``set_n_clusters``
        may ask for (None: no bound), as the JAX package's argument.
    """

    mode = None  # the cfg.mode the subclass runs
    needs_full_images = False
    in_flight = 2  # units dispatched ahead of the blocking finish

    def __init__(self, cfg: LabelGenConfig, state_dict=None,
                 model_name: str = "drn_c_26", seed: Optional[int] = None,
                 device="cuda", dynamic_k: Optional[int] = None):
        self.device = resolve_device(device)
        self.dynamic_k = dynamic_k
        self._check_k(cfg)
        self._validate(cfg)
        self.cfg = cfg
        if self.device.type == "cuda":
            # stated, not inherited: float32 convolutions and matmuls run
            # in full float32 (cuDNN would otherwise use TF32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._model_name, self._state_dict = model_name, state_dict
        self.model = self._build_model(self._model_dtype(cfg))
        seed = cfg.kmeans.seed if seed is None else seed
        self._seed_rng = np.random.RandomState(seed)
        # the parity mode's replicas of the reference's process-global
        # streams (random.seed / np.random.seed, batch_spalign_kmeans.py:
        # 33-35): numpy for the k-means init (:148), python for the
        # per-superpixel anchor shuffle (:232)
        self._parity_rng = np.random.RandomState(seed)
        self._parity_pyrng = random.Random(seed)
        self._configure()
        self._upload_stream = (torch.cuda.Stream(device=self.device)
                               if self.device.type == "cuda" else None)
        self._want_cluster_np = False  # set by process_dataset when saving

    @staticmethod
    def _model_dtype(cfg: LabelGenConfig) -> torch.dtype:
        """The DRN's compute dtype: the parity mode pins float32 whatever
        model_dtype says (its contract is the reference's float32/float64
        host arithmetic)."""
        if cfg.kmeans.init == "reference":
            return torch.float32
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[cfg.model_dtype]

    def _build_model(self, dtype: torch.dtype):
        """The DRN with the generator's weights (the given state_dict, or
        the factory's seeded random weights) in ``dtype`` on the device,
        channels_last on the card."""
        model = DRN_FACTORIES[self._model_name](device="cpu")
        if self._state_dict is not None:
            model.load_state_dict(self._state_dict, strict=True)
        model = model.to(device=self.device, dtype=dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model.eval()

    def _configure(self):
        """What the generator derives from self.cfg (the subclasses add
        their superpixel geometry)."""
        p = self.cfg.prior
        self._prior_params = (p.y_rel_pos, p.x_rel_pos, p.y_rel_sigma,
                              p.x_rel_sigma)

    def _check_k(self, cfg: LabelGenConfig):
        if self.dynamic_k is not None and cfg.kmeans.n_clusters > \
                self.dynamic_k:
            raise ValueError(f"n_clusters={cfg.kmeans.n_clusters} > "
                             f"dynamic_k bound {self.dynamic_k}")

    # --- sweep support: one generator, a config a row ---

    def reconfigure(self, cfg: LabelGenConfig):
        """Adopt a new config: validated, the DRN rebuilt (same weights)
        when the compute dtype changes, everything derived from the
        config recomputed.  The seed streams go on where they are."""
        self._check_k(cfg)
        self._validate(cfg)
        dtype = self._model_dtype(cfg)
        if dtype != self._model_dtype(self.cfg):
            self.model = self._build_model(dtype)
        self.cfg = cfg
        self._configure()

    def set_n_clusters(self, k: int):
        """Change the k-means cluster count (within ``dynamic_k``)."""
        self.reconfigure(dataclasses.replace(
            self.cfg,
            kmeans=dataclasses.replace(self.cfg.kmeans, n_clusters=k)))

    def n_program_traces(self) -> int:
        """The JAX package's count of traced programs; torch traces
        nothing, so -1, its value for "unavailable"."""
        return -1

    def _validate(self, cfg: LabelGenConfig):
        """Raise on a configuration this generator does not run, and on
        the JAX package's wire rules (its ``_validate_wire``)."""
        if cfg.mode != self.mode:
            raise NotImplementedError(
                f"mode={cfg.mode!r}: {type(self).__name__} runs mode="
                f"{self.mode!r}; make_label_generator picks the generator "
                f"of a mode")
        if cfg.save_images:
            raise NotImplementedError("diagnostic panels are not ported")
        if cfg.upload_format == "rgb8":
            return
        if cfg.upload_format != "yuv420":
            raise ValueError(f"unknown upload_format {cfg.upload_format}")
        h, w = cfg.resize_shape
        if h % 2 or w % 2:
            raise ValueError("yuv420 needs even resize_shape")
        if cfg.kmeans.init == "reference":
            raise ValueError("parity mode is bit-exact from raw RGB; "
                             "yuv420 is lossy: use rgb8")
        if cfg.mode == "spalign" and not fused_superpixels(cfg):
            raise ValueError(
                "yuv420 on the spalign path needs the device SLIC frontend "
                "(the host superpixel engines take the raw images)")

    # --- the device program ---

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) RGB 0..255 on the device -> (B, hf, wf, C)
        float32 concatenated DRN maps."""
        x = preprocess_imagenet(images)
        return self.model.features(x, self.cfg.use_feature_maps)

    def decode(self, wire: torch.Tensor) -> torch.Tensor:
        """Uploaded batch (wire format) -> (B, H, W, 3) uint8 RGB."""
        if self.cfg.upload_format == "yuv420":
            return decode_yuv420(wire, self.cfg.resize_shape)
        return wire

    # --- host side ---

    def _next_seed(self) -> np.uint32:
        return np.uint32(self._seed_rng.randint(0, 2 ** 31))

    def _unit_seeds(self, n_groups: int):
        return [self._next_seed() for _ in range(n_groups)]

    def _upload(self, host_array: np.ndarray):
        """Start a host array's copy to the device: pinned memory and a
        non-blocking copy on the upload stream.  Returns (pinned host
        tensor, device tensor, the copy's event or None on the CPU)."""
        host = torch.from_numpy(np.ascontiguousarray(host_array))
        if self._upload_stream is None:
            return host, host, None
        host = host.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return host, dev, ready

    def _host_prepare(self, images_uint8: np.ndarray, full_images=None,
                      timers: Optional[StageTimer] = None) -> dict:
        """Wire-pack the batch and start its upload (runs on the producer
        thread, so it overlaps the previous unit's device work).  The
        device tensors a unit uses, each with the event its producer
        recorded, are listed under ``"ready"``."""
        timers = timers or StageTimer()
        with timers.stage("upload"):
            images_uint8 = np.ascontiguousarray(images_uint8)
            host, wire, ready = self._upload(
                native.pack_yuv420(images_uint8)
                if self.cfg.upload_format == "yuv420" else images_uint8)
        return {"wire": wire, "host": [host], "ready": [(wire, ready)]}

    def _host_superpixels(self, images_uint8: np.ndarray, prepared: dict,
                          timers: StageTimer, device_images=None):
        """A host engine's maps of a batch, uploaded at the narrowest
        integer width that holds their ids; the device maps go to
        ``prepared["sps"]`` (with their event under ``"ready"``), the host
        maps to ``"sps_host"`` and the per-image counts to ``"counts"``.
        SLIC runs on the upload stream: ordered after the uploads it
        reads, it overlaps the compute stream's work."""
        stream = (contextlib.nullcontext() if self._upload_stream is None
                  else torch.cuda.stream(self._upload_stream))
        with timers.stage("superpixel"), stream:
            sps, counts = compute_superpixels(
                images_uint8, self.cfg.superpixel, device=self.device,
                device_images=device_images)
        narrow = (np.uint8 if counts.max() < 2 ** 8 else
                  np.int16 if counts.max() < 2 ** 15 else np.int32)
        with timers.stage("upload"):
            host, dev, ready = self._upload(sps.astype(narrow))
        prepared["host"].append(host)
        prepared["ready"].append((dev, ready))
        prepared.update(sps=dev, sps_host=sps, counts=counts)
        return prepared

    def _wait_ready(self, prepared: dict):
        """Make the current stream wait for the unit's uploads (and any
        other device work of the producer thread)."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        for tensor, event in prepared["ready"]:
            stream.wait_event(event)
            tensor.record_stream(stream)

    def _to_host(self, fetch: dict):
        """Start device tensors on their way to the host (pinned,
        non-blocking); returns (host tensors, the event to wait for)."""
        if self.device.type != "cuda":
            return fetch, None
        host = {}
        for name, t in fetch.items():
            host[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[name].copy_(t, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(self.device))
        return host, landed

    @staticmethod
    def _landed(handles: dict) -> dict:
        """Wait for a dispatch's ``_to_host`` copies; numpy arrays."""
        host, landed = handles["_host"]
        if landed is not None:
            landed.synchronize()
        return {name: t.numpy() for name, t in host.items()}

    def dispatch_batch(self, prepared: dict, timers: StageTimer) -> dict:
        raise NotImplementedError

    def finish_batch(self, prepared: dict, handles: dict,
                     timers: StageTimer):
        """Wait for the unit's results: (road (B, h, w) bool device
        tensor, cluster maps, diagnostics with per-group lists under
        ``_per_group``); the landed numpy arrays go to
        ``handles["host"]``."""
        raise NotImplementedError

    def run_batch(self, images_uint8: np.ndarray,
                  timers: Optional[StageTimer] = None, full_images=None):
        """Synchronous single-batch API: (B, h, w, 3) uint8 RGB at
        cfg.resize_shape (and the full-resolution frames where the mode
        needs them), one clustering group.  Returns (road_masks bool,
        cluster_maps int32, diagnostics, StageTimer)."""
        timers = timers or StageTimer()
        prepared = self._host_prepare(images_uint8, full_images, timers)
        handles = self.dispatch_batch(prepared, timers)
        road, cluster, diag = self.finish_batch(prepared, handles, timers)
        per_group = diag.pop("_per_group")
        diag.update({k: (v[0] if len(v) == 1 else v)
                     for k, v in per_group.items()})
        return road, cluster, diag, timers

    def process_dataset(self, dataset, start_index: int = 0,
                        end_index: Optional[int] = None,
                        save: Optional[bool] = None,
                        writer: Optional[ResultWriter] = None,
                        prefetch: int = 2,
                        skip_done: Optional[set] = None):
        """Label a dataset of (image uint8 full-res, labelIds or None)
        pairs in clustering batches, ``groups_per_dispatch`` batches per
        unit.  One producer thread loads and uploads ``prefetch`` units
        ahead; ``in_flight`` units are dispatched before the oldest one
        is finished.  ``skip_done``: image names whose batches are all
        done already (a restart) are skipped.  Returns the per-image
        records."""
        cfg = self.cfg
        n = len(dataset)
        end_index = n if end_index is None else min(end_index, n)
        save = cfg.save_masks if save is None else save
        if writer is None and save:
            writer = ResultWriter(cfg.out_dir)
        slices = batch_slices(start_index, end_index, cfg.batchsize)
        if skip_done:
            slices = [(i, j) for i, j in slices
                      if not all(_name(dataset, "image_name", idx)
                                 in skip_done for idx in range(i, j))]
        # the parity mode keeps one group a unit: its host init consumes
        # the reference's sequential numpy stream batch by batch
        groups = (1 if cfg.kmeans.init == "reference"
                  else max(1, cfg.groups_per_dispatch))
        units = [slices[x:x + groups] for x in range(0, len(slices), groups)]
        self._want_cluster_np = bool(save)
        records = []
        pending = deque()
        for item in self._prefetched(dataset, units, prefetch):
            handles = self.dispatch_batch(item[4], item[5])
            pending.append((item, handles))
            if len(pending) > self.in_flight:
                records.extend(self._finish_loaded(
                    dataset, *pending.popleft(), save=save, writer=writer))
        while pending:
            records.extend(self._finish_loaded(
                dataset, *pending.popleft(), save=save, writer=writer))
        return records

    def _load_unit(self, dataset, unit):
        indices = [idx for (i, j) in unit for idx in range(i, j)]
        timers = StageTimer()
        with timers.stage("load"):
            imgs, labels = _load_batch(dataset, indices,
                                       self.cfg.resize_shape)
            full_images = (_load_full_images(dataset, indices)
                           if self.needs_full_images else None)
        prepared = self._host_prepare(imgs, full_images, timers)
        prepared["n_groups"] = len(unit)
        return (indices, imgs, labels, full_images, prepared, timers)

    def _prefetched(self, dataset, units, depth):
        """Yield loaded units in order, ``depth`` ahead on one thread."""
        if depth <= 0 or len(units) <= 1:
            for unit in units:
                yield self._load_unit(dataset, unit)
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            it = iter(units)
            futures = deque()

            def submit_next():
                unit = next(it, None)
                if unit is not None:
                    futures.append(ex.submit(self._load_unit, dataset,
                                             unit))

            for _ in range(depth):
                submit_next()
            while futures:
                item = futures.popleft().result()
                submit_next()
                yield item

    def _finish_loaded(self, dataset, item, handles, *, save, writer):
        cfg = self.cfg
        indices, imgs, labels, _, prepared, timers = item
        road, _, diag = self.finish_batch(prepared, handles, timers)
        per_group = diag.pop("_per_group")
        group_size = len(indices) // int(prepared.get("n_groups", 1))
        got = handles["host"]
        # packed masks may travel at 1/u of the mask resolution (overlaps
        # with slic_device_downscale = u: the masks are u x u block-
        # constant, so repeating restores them bit for bit)
        u = int(handles.get("packed_upscale", 1))
        road_np = unpack_mask_bits(got["road_packed"], road.shape[-1] // u)
        if u > 1:
            road_np = road_np.repeat(u, axis=1).repeat(u, axis=2)
        if labels is not None:
            with timers.stage("score"):
                confs = [host_confusion(r, l)
                         for r, l in zip(road_np, labels)]
        else:
            confs = [None] * len(indices)
        if save:
            out_hw = (tuple(labels.shape[1:]) if labels is not None
                      else tuple(road_np.shape[1:]))
            up_road = nn_resize_np(road_np.astype(np.uint8), out_hw)
            up_cluster = nn_resize_np(got["cluster"], out_hw)
            os.makedirs(cfg.out_dir, exist_ok=True)
        times = timers.finish()
        cfg_flat = flatten(cfg)
        records = []
        for b, idx in enumerate(indices):
            img_fn = _name(dataset, "image_name", idx)
            rec = {"img_fn": img_fn,
                   "label_fn": _name(dataset, "label_name", idx)}
            if confs[b] is not None:
                rec.update(_confusion_record(confs[b]))
            rec.update(cfg_flat)
            rec.update(times)
            rec.update(diag)
            gi = min(b // group_size,
                     len(next(iter(per_group.values()))) - 1)
            rec.update({k: v[gi] for k, v in per_group.items()})
            records.append(rec)
            if save:
                base = os.path.splitext(os.path.basename(img_fn))[0]
                np.save(os.path.join(cfg.out_dir, base), up_road[b])
                np.save(os.path.join(cfg.out_dir, base + "_all_cluster"),
                        up_cluster[b])
                if labels is None:
                    # without ground truth the raw 0/1 mask is also
                    # written as a PNG under the image's file name, the
                    # format the demo-video compositor reads (reference
                    # utils/apply_spalign_kmeans.py:70-71)
                    write_png(os.path.join(cfg.out_dir,
                                           os.path.basename(img_fn)),
                              up_road[b].astype(np.uint8))
        if writer is not None:
            writer.append_many(records)
        return records


class SpalignLabelGenerator(LabelGeneratorBase):
    """End-to-end label generation over a dataset (reference
    batch_spalign_kmeans.py main loop :533-548 + estimate_road_mask),
    with either superpixel frontend (module docstring) and either k-means
    init."""

    mode = "spalign"

    def _configure(self):
        """The superpixel geometry: with the device SLIC frontend, the
        maps' shape at 1/d and K = its grid size; with a host engine,
        K = max_superpixels."""
        super()._configure()
        cfg = self.cfg
        if fused_superpixels(cfg):
            d = cfg.superpixel.slic_device_downscale
            self._sp_hw = (cfg.resize_shape[0] // d,
                           cfg.resize_shape[1] // d)
            self.num_segments = slic_grid_size(
                *self._sp_hw, cfg.superpixel.n_slic_segments)
        else:
            d = 1
            self.num_segments = cfg.superpixel.max_superpixels
        self._downscale = d

    def superpixels(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, h, w) int32 SLIC maps of the device
        SLIC frontend, at 1/d of the image resolution when
        slic_device_downscale = d > 1."""
        sp = self.cfg.superpixel
        d = self._downscale
        if d > 1:
            n = images.shape[0]
            images = images.to(torch.float32).reshape(
                n, self._sp_hw[0], d, self._sp_hw[1], d, 3).mean(dim=(2, 4))
        return slic(images, n_segments=sp.n_slic_segments,
                    compactness=sp.slic_compactness, n_iter=sp.slic_iters,
                    device=self.device)

    def _host_prepare(self, images_uint8: np.ndarray, full_images=None,
                      timers: Optional[StageTimer] = None) -> dict:
        """Upload the batch; with a host engine, compute its superpixels
        (SLIC from the uploaded batch) and upload the maps too."""
        timers = timers or StageTimer()
        prepared = super()._host_prepare(images_uint8, full_images, timers)
        if fused_superpixels(self.cfg):
            return prepared
        return self._host_superpixels(images_uint8, prepared, timers,
                                      device_images=prepared["wire"])

    @torch.no_grad()
    def run_unit(self, wire: torch.Tensor, seeds: Sequence[int],
                 draws: Optional[UnitDraws] = None,
                 sps: Optional[torch.Tensor] = None) -> dict:
        """The whole device program of one unit: G = len(seeds) groups.
        ``sps``: the host engine's maps (ids < max_superpixels); None runs
        the device SLIC frontend.  Returns device tensors: road,
        road_packed, cluster, assign, the KMeansResult ``res``, per-group
        ``ok`` and the superpixel maps."""
        cfg = self.cfg
        images = self.decode(wire)
        sps = self.superpixels(images) if sps is None else sps.to(
            torch.int32)
        fmaps = self.features(images)
        g = len(seeds)
        hw = sps.shape[1] * sps.shape[2]
        if draws is None:
            draws = draw_unit(seeds, sps.shape[0] // g, hw,
                              self.num_segments, self.device)
        road, cluster, assign, res, ok = cluster_groups(
            fmaps, sps, draws, n_groups=g, n_anchors=cfg.align.n_anchors,
            num_segments=self.num_segments,
            append_pos=cfg.align.append_pos, k=cfg.kmeans.n_clusters,
            n_iter=cfg.kmeans.n_iter, prior_params=self._prior_params,
            pos_scale=float(self._downscale))
        return {"road": road, "road_packed": pack_mask_bits(road),
                "cluster": cluster, "assign": assign, "res": res, "ok": ok,
                "superpixels": sps}

    @torch.no_grad()
    def run_parity(self, prepared: dict, timers: StageTimer) -> dict:
        """The bit-parity unit (one clustering group), every random draw
        of the reference replayed (batch_spalign_kmeans.py:33-35 seeds;
        :232 anchors, :148 init): DRN features (float32) to the host ->
        the anchor shuffle + align of ``reference_superpixel_align`` and
        the float64 prior, image by image on this thread -> the seed-1111
        init over the batch's concatenated prior -> the Lloyd loop and
        painting on the device.  Align and prior are cached in
        ``prepared``: a retry re-runs only the init and the Lloyd loop,
        as the reference's retry re-calls only its k-means (:201-205).
        Returns the device tensors of ``run_unit``."""
        cfg = self.cfg
        s = self.num_segments
        counts = prepared["counts"]
        b = len(counts)
        if "parity" not in prepared:
            with timers.stage("features", self.device):
                fmaps = self.features(self.decode(prepared["wire"])).to(
                    torch.float32).cpu().numpy()
            sps_host = prepared["sps_host"]
            with timers.stage("align"):
                feats_c = [reference_superpixel_align(
                    fmaps[i], sps_host[i], self._parity_pyrng,
                    n_select=cfg.align.n_anchors,
                    n_neighbor=cfg.align.n_neighbors,
                    append_pos=cfg.align.append_pos) for i in range(b)]
            p = cfg.prior
            with timers.stage("prior"):
                prior_c = [superpixel_prior_host(
                    sps_host[i], p.y_rel_pos, p.x_rel_pos, p.y_rel_sigma,
                    p.x_rel_sigma) for i in range(b)]
            feats = np.zeros((b, s, feats_c[0].shape[1]), np.float32)
            prior = np.zeros((b, s), np.float32)
            valid = np.zeros((b, s), bool)
            for i, n_i in enumerate(counts):
                feats[i, :n_i] = feats_c[i]
                prior[i, :n_i] = prior_c[i]
                valid[i, :n_i] = True
            prepared["parity"] = (
                torch.from_numpy(feats).to(self.device).reshape(1, b * s, -1),
                torch.from_numpy(prior).to(self.device).reshape(1, b * s),
                torch.from_numpy(valid).to(self.device).reshape(1, b * s),
                np.concatenate(prior_c))
        feats, prior, valid, prior_cat = prepared["parity"]
        a_cat = reference_seed_assignment(prior_cat, cfg.kmeans.n_clusters,
                                          self._parity_rng)
        assign0 = np.full((b, s), -1, np.int32)
        o = 0
        for i, n_i in enumerate(counts):
            assign0[i, :n_i] = a_cat[o:o + n_i]
            o += int(n_i)
        with timers.stage("device_program", self.device):
            res = weighted_kmeans_from_init(
                feats, prior, valid,
                torch.from_numpy(assign0).to(self.device).reshape(1, -1),
                k=cfg.kmeans.n_clusters, n_iter=cfg.kmeans.n_iter,
                check_every=KMEANS_CHECK_EVERY)
            sps = prepared["sps"].to(torch.int32)
            assign = res.assignment.reshape(b, s)
            cluster = paint_clusters(sps, assign)
            road = cluster == 0
            ok = road.flatten(1).any(1).all().reshape(1)
        return {"road": road, "road_packed": pack_mask_bits(road),
                "cluster": cluster, "assign": assign, "res": res, "ok": ok,
                "superpixels": sps}

    def dispatch_batch(self, prepared: dict, timers: StageTimer) -> dict:
        """Run the unit's device program; the masks and diagnostics start
        their way to the host (pinned, non-blocking), and ``finish_batch``
        waits for them."""
        self._wait_ready(prepared)
        if self.cfg.kmeans.init == "reference":
            handles = self.run_parity(prepared, timers)
        else:
            seeds = self._unit_seeds(int(prepared.get("n_groups", 1)))
            with timers.stage("device_program", self.device):
                handles = self.run_unit(prepared["wire"], seeds,
                                        sps=prepared.get("sps"))
        res = handles["res"]
        fetch = {"road_packed": handles["road_packed"], "ok": handles["ok"],
                 "n_iter": res.n_iter, "converged": res.converged,
                 "empty_stop": res.empty_stop}
        if self._want_cluster_np:
            fetch["cluster"] = handles["cluster"].to(torch.uint8)
        handles["_host"] = self._to_host(fetch)
        return handles

    def finish_batch(self, prepared: dict, handles: dict,
                     timers: StageTimer):
        """Wait for the unit's results; when a group has an all-empty
        road mask, re-run the whole unit with fresh seeds (the parity
        mode: the next init of its stream), up to cfg.kmeans.max_retries
        runs in all (the reference's retry at :201-205, whose result it
        discarded)."""
        cfg = self.cfg
        tries = max(1, cfg.kmeans.max_retries)
        retries = 0
        with timers.stage("kmeans"):
            for attempt in range(tries):
                got = self._landed(handles)
                if bool(np.all(got["ok"])) or attempt + 1 >= tries:
                    break
                retries += 1
                handles.update(self.dispatch_batch(prepared, timers))
        handles["host"] = got
        n = handles["road"].shape[0]
        counts = prepared.get("counts")
        diag = {
            "n_superpixels": (counts.tolist() if counts is not None
                              else [self.num_segments] * n),
            "retries": retries,
            "_per_group": {
                "kmeans_iters": got["n_iter"].astype(int).tolist(),
                "kmeans_converged": got["converged"].astype(bool).tolist(),
                "kmeans_empty_stop": got["empty_stop"].astype(
                    bool).tolist(),
            },
        }
        return handles["road"], handles["cluster"], diag
