"""Label generation on the fused-SLIC path: the road-mask program on the card.

Counterpart of ``spalign_tpu/pipeline/label_gen.py`` on its fused-SLIC
path (``SpalignLabelGenerator._fused_program``).  For each unit of G
clustering groups of ``batchsize`` images:

    yuv420 wire -> decode -> [d x d box mean] -> SLIC (CUDA kernel)
      -> DRN features -> superpixel-align -> prior -> per-group weighted
      k-means -> paint -> bit-packed road masks

run eagerly on one device; then on the host: the bounded retry when a
road mask comes out empty, scoring against full-resolution labelIds, and
optional ``.npy`` mask saving.

Random draws (anchor bits and the k-means seeding uniforms) come from a
``torch.Generator`` seeded per group from the host seed stream, or are
passed in (``UnitDraws``) so that tests can hand the port the JAX
package's draws.

Not ported yet (they raise ``NotImplementedError``): the host superpixel
engines (felzenszwalb, SLIC with connectivity), the bit-parity mode
(``kmeans.init='reference'``), the direct and overlaps modes and the
dynamic-k sweep.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spalign_tpu_torch.config import LabelGenConfig, flatten
from spalign_tpu_torch.eval.results import ResultWriter
from spalign_tpu_torch.kernels.slic import slic, slic_grid_size
from spalign_tpu_torch.models.drn import DRN_FACTORIES, preprocess_imagenet
from spalign_tpu_torch.ops.align import superpixel_align
from spalign_tpu_torch.ops.kmeans import paint_clusters, weighted_kmeans
from spalign_tpu_torch.ops.prior import superpixel_prior
from spalign_tpu_torch.ops.segments import anchor_key_bits
from spalign_tpu_torch.pipeline.wire import decode_yuv420, pack_yuv420
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
    full-resolution raw Cityscapes labelIds (void ids 0..6 ignored):
    NN-upsample, LUT, bincount."""
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


def _load_batch(dataset, indices, resize_hw):
    """(B, h, w, 3) uint8 resized images + full-res labelIds (or None)."""
    if hasattr(dataset, "resized_batch"):
        return dataset.resized_batch(list(indices), resize_hw)
    from spalign_tpu_torch.data.synthetic import resize_bicubic_u8

    imgs, labels = [], []
    for idx in indices:
        item = dataset[idx]
        img, lab = item if isinstance(item, tuple) else (item, None)
        if img.shape[:2] != tuple(resize_hw):
            img = resize_bicubic_u8(img, resize_hw)
        imgs.append(img)
        labels.append(lab)
    labels = None if labels[0] is None else np.stack(labels)
    return np.stack(imgs), labels


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


class SpalignLabelGenerator:
    """End-to-end label generation over a dataset (reference
    batch_spalign_kmeans.py main loop :533-548 + estimate_road_mask), on
    the fused-SLIC path.

    Args:
      cfg: LabelGenConfig with superpixel method 'slic',
        slic_enforce_connectivity=False and kmeans.init='device'.
      state_dict: DRN weights (e.g. from ``convert.from_jax``); random
        weights from a fixed seed when None.
      seed: host seed stream of the per-group seeds (default
        cfg.kmeans.seed).
      device: 'cuda' (default; raises without CUDA) or 'cpu'.
    """

    in_flight = 2  # units dispatched ahead of the blocking finish

    def __init__(self, cfg: LabelGenConfig, state_dict=None,
                 model_name: str = "drn_c_26", seed: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        _validate(cfg)
        self.cfg = cfg
        if self.device.type == "cuda":
            # stated, not inherited: float32 convolutions and matmuls run
            # in full float32 (cuDNN would otherwise use TF32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = DRN_FACTORIES[model_name](device="cpu")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[cfg.model_dtype]
        model = model.to(device=self.device, dtype=dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model.eval()
        self._seed_rng = np.random.RandomState(
            cfg.kmeans.seed if seed is None else seed)
        p = cfg.prior
        self._prior_params = (p.y_rel_pos, p.x_rel_pos, p.y_rel_sigma,
                              p.x_rel_sigma)
        d = cfg.superpixel.slic_device_downscale
        self._downscale = d
        self._sp_hw = (cfg.resize_shape[0] // d, cfg.resize_shape[1] // d)
        self.num_segments = slic_grid_size(
            *self._sp_hw, cfg.superpixel.n_slic_segments)
        self._upload_stream = (torch.cuda.Stream(device=self.device)
                               if self.device.type == "cuda" else None)
        self._want_cluster_np = False  # set by process_dataset when saving

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

    def superpixels(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, h, w) int32 SLIC maps, at 1/d of the
        image resolution when slic_device_downscale = d > 1."""
        sp = self.cfg.superpixel
        d = self._downscale
        if d > 1:
            n = images.shape[0]
            images = images.to(torch.float32).reshape(
                n, self._sp_hw[0], d, self._sp_hw[1], d, 3).mean(dim=(2, 4))
        return slic(images, n_segments=sp.n_slic_segments,
                    compactness=sp.slic_compactness, n_iter=sp.slic_iters,
                    device=self.device)

    @torch.no_grad()
    def run_unit(self, wire: torch.Tensor, seeds: Sequence[int],
                 draws: Optional[UnitDraws] = None) -> dict:
        """The whole device program of one unit: G = len(seeds) groups.
        Returns device tensors: road, road_packed, cluster, assign, the
        KMeansResult ``res``, per-group ``ok`` and the superpixel maps."""
        cfg = self.cfg
        images = self.decode(wire)
        sps = self.superpixels(images)
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

    # --- host side ---

    def _next_seed(self) -> np.uint32:
        return np.uint32(self._seed_rng.randint(0, 2 ** 31))

    def _unit_seeds(self, n_groups: int):
        return [self._next_seed() for _ in range(n_groups)]

    def _host_prepare(self, images_uint8: np.ndarray) -> dict:
        """Wire-pack the batch and start its upload: pinned memory and a
        non-blocking copy on the upload stream (runs on the producer
        thread, so it overlaps the previous unit's device work)."""
        images_uint8 = np.ascontiguousarray(images_uint8)
        host = (pack_yuv420(images_uint8)
                if self.cfg.upload_format == "yuv420" else images_uint8)
        host = torch.from_numpy(host)
        if self._upload_stream is None:
            return {"wire": host, "host": host, "ready": None}
        host = host.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            wire = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return {"wire": wire, "host": host, "ready": ready}

    def dispatch_batch(self, prepared: dict, timers: StageTimer) -> dict:
        """Run the unit's device program; the masks and diagnostics start
        their way to the host (pinned, non-blocking), and ``finish_batch``
        waits for them."""
        wire = prepared["wire"]
        if prepared["ready"] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(prepared["ready"])
            wire.record_stream(stream)
        seeds = self._unit_seeds(int(prepared.get("n_groups", 1)))
        with timers.stage("device_program", self.device):
            handles = self.run_unit(wire, seeds)
        res = handles["res"]
        fetch = {"road_packed": handles["road_packed"], "ok": handles["ok"],
                 "n_iter": res.n_iter, "converged": res.converged,
                 "empty_stop": res.empty_stop}
        if self._want_cluster_np:
            fetch["cluster"] = handles["cluster"].to(torch.uint8)
        if self.device.type == "cuda":
            host = {}
            for name, t in fetch.items():
                host[name] = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                host[name].copy_(t, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))
        else:
            host, landed = fetch, None
        handles["_host"] = (host, landed)
        return handles

    def finish_batch(self, prepared: dict, handles: dict,
                     timers: StageTimer):
        """Wait for the unit's results; when a group has an all-empty
        road mask, re-run the whole unit with fresh seeds, up to
        cfg.kmeans.max_retries runs in all (the reference's retry at
        :201-205, whose result it discarded)."""
        cfg = self.cfg
        tries = max(1, cfg.kmeans.max_retries)
        retries = 0
        with timers.stage("kmeans"):
            for attempt in range(tries):
                host, landed = handles["_host"]
                if landed is not None:
                    landed.synchronize()
                got = {name: t.numpy() for name, t in host.items()}
                if bool(np.all(got["ok"])) or attempt + 1 >= tries:
                    break
                retries += 1
                handles.update(self.dispatch_batch(prepared, timers))
        handles["host"] = got
        diag = {
            "n_superpixels": [self.num_segments] * handles["road"].shape[0],
            "retries": retries,
            "_per_group": {
                "kmeans_iters": got["n_iter"].astype(int).tolist(),
                "kmeans_converged": got["converged"].astype(bool).tolist(),
                "kmeans_empty_stop": got["empty_stop"].astype(
                    bool).tolist(),
            },
        }
        return handles["road"], handles["cluster"], diag

    def run_batch(self, images_uint8: np.ndarray,
                  timers: Optional[StageTimer] = None):
        """Synchronous single-batch API: (B, h, w, 3) uint8 RGB at
        cfg.resize_shape, one clustering group.  Returns (road_masks
        (B, h, w) bool, cluster_maps int32, diagnostics, StageTimer)."""
        timers = timers or StageTimer()
        prepared = self._host_prepare(images_uint8)
        handles = self.dispatch_batch(prepared, timers)
        road, cluster, diag = self.finish_batch(prepared, handles, timers)
        per_group = diag.pop("_per_group")
        diag.update({k: v[0] for k, v in per_group.items()})
        return road, cluster, diag, timers

    def process_dataset(self, dataset, start_index: int = 0,
                        end_index: Optional[int] = None,
                        save: Optional[bool] = None,
                        writer: Optional[ResultWriter] = None,
                        prefetch: int = 2):
        """Label a dataset of (image uint8 full-res, labelIds or None)
        pairs in clustering batches, ``groups_per_dispatch`` batches per
        unit.  One producer thread loads and uploads ``prefetch`` units
        ahead; ``in_flight`` units are dispatched before the oldest one
        is finished.  Returns the per-image records."""
        cfg = self.cfg
        n = len(dataset)
        end_index = n if end_index is None else min(end_index, n)
        save = cfg.save_masks if save is None else save
        if writer is None and (save or cfg.save_images):
            writer = ResultWriter(cfg.out_dir)
        slices = batch_slices(start_index, end_index, cfg.batchsize)
        groups = max(1, cfg.groups_per_dispatch)
        units = [slices[x:x + groups] for x in range(0, len(slices), groups)]
        self._want_cluster_np = bool(save)
        records = []
        pending = deque()
        for item in self._prefetched(dataset, units, prefetch):
            handles = self.dispatch_batch(item[3], item[4])
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
        with timers.stage("upload"):
            prepared = self._host_prepare(imgs)
        prepared["n_groups"] = len(unit)
        return (indices, imgs, labels, prepared, timers)

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
        indices, imgs, labels, prepared, timers = item
        road, _, diag = self.finish_batch(prepared, handles, timers)
        per_group = diag.pop("_per_group")
        group_size = len(indices) // int(prepared.get("n_groups", 1))
        got = handles["host"]
        road_np = unpack_mask_bits(got["road_packed"], road.shape[-1])
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
        if writer is not None:
            writer.append_many(records)
        return records


def _validate(cfg: LabelGenConfig):
    sp = cfg.superpixel
    if cfg.mode != "spalign":
        raise NotImplementedError(
            f"mode={cfg.mode!r}: only the spalign mode is ported")
    if cfg.kmeans.init != "device":
        raise NotImplementedError("the bit-parity mode (kmeans.init="
                                  "'reference') is not ported")
    if sp.method != "slic" or sp.slic_enforce_connectivity:
        raise NotImplementedError(
            "only the device SLIC frontend (method='slic', "
            "slic_enforce_connectivity=False) is ported; the host "
            "superpixel engines are not")
    if cfg.save_images:
        raise NotImplementedError("diagnostic panels are not ported")
    if cfg.upload_format not in ("rgb8", "yuv420"):
        raise ValueError(f"unknown upload_format {cfg.upload_format}")
    h, w = cfg.resize_shape
    if cfg.upload_format == "yuv420" and (h % 2 or w % 2):
        raise ValueError("yuv420 needs even resize_shape")
