"""Baseline label modes: direct pixel clustering and superpixel overlaps.

Counterpart of ``spalign_tpu/pipeline/direct.py``.

- 'direct' (reference direct_clustering.py): weighted k-means directly on
  feature-map pixels -- the flattened (B*hf*wf, C) map with the integer
  (x, y) cell coordinates appended (:300-303), the per-pixel Gaussian
  prior at feature-map resolution (:307-309), one joint k-means per
  clustering group (:314); road mask = cluster 0 (:329-332).

- 'overlaps' (reference superpixel_overlaps.py): direct clustering, then
  the coarse road mask is snapped to full-resolution superpixels -- a
  superpixel is road when overlap / n_predicted_road_pixels >
  overlap_threshold (:359-369).  The superpixels of the full-resolution
  frames are computed on the producer thread, by the device SLIC
  frontend (per-sweep engine, ``csrc/slic_assign.cu``; the maps stay on
  the device) or by a host engine (felzenszwalb, the reference's
  default, or SLIC with the connectivity pass; the maps are uploaded).

Both modes run under either k-means init: they never read it, and the
parity mode only pins the DRN to float32 and one group a unit.

Random draws (the k-means seeding uniforms) come from a
``torch.Generator`` seeded per group from the host seed stream, or are
passed in so that tests can hand the port the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.config import LabelGenConfig
from spalign_tpu_torch.kernels.slic import slic_grid_size
from spalign_tpu_torch.ops.kmeans import weighted_kmeans
from spalign_tpu_torch.ops.prior import pixel_prior
from spalign_tpu_torch.ops.resize import nn_resize_cv2
from spalign_tpu_torch.pipeline.label_gen import (KMEANS_CHECK_EVERY,
                                                  LabelGeneratorBase,
                                                  SpalignLabelGenerator,
                                                  pack_mask_bits)
from spalign_tpu_torch.pipeline.superpixels import (batched_slic_device,
                                                    batched_slic_device_yuv)
from spalign_tpu_torch.utils.timers import StageTimer


def _pixel_features(feature_maps: torch.Tensor, prior_params):
    """Flattened per-pixel rows with (x, y) cell coordinates appended in
    that order, and the feature-resolution prior tiled over the batch
    (reference direct_clustering.py:300-309): ((B*h*w, C+2), (B*h*w,))."""
    b, h, w, c = feature_maps.shape
    dev = feature_maps.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).repeat(b, 1)
    X = torch.cat([feature_maps.reshape(b * h * w, c), coords], -1)
    prior = pixel_prior(h, w, *prior_params, device=dev).reshape(-1)
    return X, prior.repeat(b)


def draw_uniforms(seeds: Sequence[int], n: int, device) -> torch.Tensor:
    """The port's own seeding uniforms: (G, n), one generator per group
    seeded with the group's host seed."""
    return torch.stack([
        torch.rand((n,), generator=torch.Generator(
            device=device).manual_seed(int(seed)), device=device)
        for seed in seeds])


def direct_cluster(feature_maps: torch.Tensor, uniforms: torch.Tensor, *,
                   k: int, n_iter: int, prior_params):
    """(B, hf, wf, C) feature maps of G = len(uniforms) clustering groups
    (the images split in order into groups of B // G) -> road maps
    (B, hf, wf) bool, cluster maps int32, the per-group KMeansResult.

    uniforms: (G, (B // G) * hf * wf) seeding uniforms in [0, 1)."""
    n, h, w, _ = feature_maps.shape
    g = uniforms.shape[0]
    X, prior = _pixel_features(feature_maps.to(torch.float32), prior_params)
    prior = prior.reshape(g, -1)
    res = weighted_kmeans(X.reshape(g, prior.shape[1], -1), prior,
                          torch.ones_like(prior, dtype=torch.bool), k=k,
                          n_iter=n_iter, uniforms=uniforms,
                          check_every=KMEANS_CHECK_EVERY)
    cluster = res.assignment.reshape(n, h, w)
    return cluster == 0, cluster, res


def overlaps_refine(road_small: torch.Tensor, superpixels_full: torch.Tensor,
                    threshold: float, num_segments: int) -> torch.Tensor:
    """Snap a coarse road mask to full-resolution superpixels.

    road_small: (B, hf, wf) bool; superpixels_full: (B, H, W) int ids in
    [0, num_segments).  A superpixel is road when its overlap with the
    NN-upsampled mask over the mask's pixel count exceeds ``threshold``
    (float32, as JAX); the overlaps are integer sums, which are exact.
    Returns (B, H, W) bool."""
    b = superpixels_full.shape[0]
    road_up = nn_resize_cv2(road_small.to(torch.int64),
                            superpixels_full.shape[1:]).reshape(b, -1)
    flat_sp = superpixels_full.reshape(b, -1).to(torch.int64)
    overlap = torch.zeros((b, num_segments), dtype=torch.int64,
                          device=road_up.device).scatter_add_(1, flat_sp,
                                                              road_up)
    n_pred = road_up.sum(1, keepdim=True)
    share = overlap.to(torch.float32) / n_pred.to(torch.float32).clamp(
        min=1.0)
    keep = (share > torch.tensor(threshold, dtype=torch.float32)) & (
        n_pred > 0)
    return keep.gather(1, flat_sp).reshape(superpixels_full.shape)


def refine_and_pack(road_small: torch.Tensor, superpixels: torch.Tensor,
                    threshold: float, num_segments: int, upscale: int = 1):
    """Overlaps refine + the bit-packed download form of its masks.

    ``upscale`` > 1: the superpixel maps are at 1/upscale of the frames
    (slic_device_downscale); the refine runs at that scale, the packed
    masks stay there (upscale^2 fewer bytes to the host, which repeats
    them back bit-equal), and the returned full-resolution masks are
    repeated on the device.  Returns (masks (B, H, W) bool, packed)."""
    refined = overlaps_refine(road_small, superpixels, threshold,
                              num_segments)
    packed = pack_mask_bits(refined)
    if upscale > 1:
        refined = refined.repeat_interleave(upscale, 1).repeat_interleave(
            upscale, 2)
    return refined, packed


class DirectLabelGenerator(LabelGeneratorBase):
    """direct_clustering.py equivalent: any superpixel setting (it uses
    none); one clustering group per batch of a unit, no retry."""

    mode = "direct"

    @torch.no_grad()
    def run_unit(self, wire: torch.Tensor, seeds: Sequence[int],
                 uniforms: Optional[torch.Tensor] = None) -> dict:
        """Decode, DRN features and the pixel k-means of G = len(seeds)
        groups.  Returns device tensors road, cluster and the
        KMeansResult ``res``."""
        fmaps = self.features(self.decode(wire))
        if uniforms is None:
            n, h, w, _ = fmaps.shape
            uniforms = draw_uniforms(seeds, n // len(seeds) * h * w,
                                     self.device)
        road, cluster, res = direct_cluster(
            fmaps, uniforms, k=self.cfg.kmeans.n_clusters,
            n_iter=self.cfg.kmeans.n_iter, prior_params=self._prior_params)
        return {"road": road, "cluster": cluster, "res": res}

    def dispatch_batch(self, prepared: dict, timers: StageTimer) -> dict:
        self._wait_ready(prepared)
        seeds = self._unit_seeds(int(prepared.get("n_groups", 1)))
        with timers.stage("device_program", self.device):
            handles = self.run_unit(prepared["wire"], seeds)
        if "full_sps" in prepared:
            upscale = prepared["sps_upscale"]
            with timers.stage("refine", self.device):
                handles["road"], handles["road_packed"] = refine_and_pack(
                    handles["road"], prepared["full_sps"],
                    self.cfg.overlap_threshold,
                    self.cfg.superpixel.max_superpixels, upscale)
            handles["packed_upscale"] = upscale
        else:
            handles["road_packed"] = pack_mask_bits(handles["road"])
        res = handles["res"]
        fetch = {"road_packed": handles["road_packed"],
                 "n_iter": res.n_iter, "converged": res.converged,
                 "empty_stop": res.empty_stop}
        if self._want_cluster_np:
            fetch["cluster"] = handles["cluster"].to(torch.uint8)
        handles["_host"] = self._to_host(fetch)
        return handles

    def finish_batch(self, prepared: dict, handles: dict,
                     timers: StageTimer):
        with timers.stage("kmeans"):
            got = self._landed(handles)
        handles["host"] = got
        diag = {"_per_group": {
            "kmeans_iters": got["n_iter"].astype(int).tolist(),
            "kmeans_converged": got["converged"].astype(bool).tolist(),
            "kmeans_empty_stop": got["empty_stop"].astype(bool).tolist(),
        }}
        if "counts" in prepared:
            diag["n_superpixels"] = prepared["counts"].tolist()
        return handles["road"], handles["cluster"], diag


class OverlapsLabelGenerator(DirectLabelGenerator):
    """superpixel_overlaps.py equivalent: direct clustering + snapping to
    superpixels of the full-resolution frames.  Road masks come back at
    full resolution (cluster maps stay at feature resolution, as in the
    reference's save path)."""

    mode = "overlaps"
    needs_full_images = True

    def _host_prepare(self, images_uint8: np.ndarray, full_images=None,
                      timers: Optional[StageTimer] = None) -> dict:
        """Upload the resized batch, then the superpixels of the
        full-resolution frames, on the producer thread so that they
        overlap the previous unit's device program: with a host engine,
        its maps (``compute_superpixels``); with the device SLIC
        frontend, the frames (yuv420 when the wire is, at 1/d with
        slic_device_downscale = d), whose SLIC runs on the upload stream
        and stays on the device."""
        if full_images is None:
            raise ValueError("overlaps mode needs full-resolution images")
        timers = timers or StageTimer()
        prepared = super()._host_prepare(images_uint8, full_images, timers)
        sp = self.cfg.superpixel
        if sp.method != "slic" or sp.slic_enforce_connectivity:
            prepared = self._host_superpixels(full_images, prepared, timers)
            prepared.update(full_sps=prepared.pop("sps"), sps_upscale=1)
            del prepared["sps_host"]
            return prepared
        b, h, w = full_images.shape[:3]
        d = sp.slic_device_downscale
        if d > 1:
            if h % d or w % d:
                raise ValueError(
                    f"slic_device_downscale={d} does not divide the full "
                    f"image shape ({h}, {w})")
            full_images = full_images[:, ::d, ::d]
            h, w = h // d, w // d
        s_grid = slic_grid_size(h, w, sp.n_slic_segments)
        if s_grid > sp.max_superpixels:
            raise ValueError(f"SLIC grid {s_grid} > max_superpixels "
                             f"{sp.max_superpixels}")
        with timers.stage("superpixel"):
            full_images = np.ascontiguousarray(full_images)
            if self.cfg.upload_format == "yuv420" and h % 2 == 0 \
                    and w % 2 == 0:
                run = batched_slic_device_yuv(
                    sp.n_slic_segments, sp.slic_compactness, sp.slic_iters,
                    (h, w))
                host, dev, ready = self._upload(
                    native.pack_yuv420(full_images))
            else:
                run = batched_slic_device(sp.n_slic_segments,
                                          sp.slic_compactness,
                                          sp.slic_iters)
                host, dev, ready = self._upload(full_images)
            if ready is None:
                sps = run(dev)
            else:
                with torch.cuda.stream(self._upload_stream):
                    sps = run(dev)  # ordered after its upload
                    ready = torch.cuda.Event()
                    ready.record(self._upload_stream)
                ready.synchronize()  # the stage covers the device SLIC
        prepared["host"].append(host)
        prepared["ready"].append((sps, ready))
        prepared.update(full_sps=sps, sps_upscale=d,
                        counts=np.full((b,), s_grid, np.int32))
        return prepared


def make_label_generator(cfg: LabelGenConfig, state_dict=None,
                         model_name: str = "drn_c_26",
                         seed: Optional[int] = None, device="cuda",
                         dynamic_k: Optional[int] = None):
    """The generator of cfg.mode: spalign, direct or overlaps."""
    cls = {"spalign": SpalignLabelGenerator,
           "direct": DirectLabelGenerator,
           "overlaps": OverlapsLabelGenerator}[cfg.mode]
    return cls(cfg, state_dict=state_dict, model_name=model_name, seed=seed,
               device=device, dynamic_k=dynamic_k)
