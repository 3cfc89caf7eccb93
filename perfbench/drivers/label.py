"""Label-generation cells: ``make_label_generator(cfg).process_dataset``
in passes over a dataset, closed loop, with the masks landing on the host.

Set-up renders the traffic's scenes, resizes them to the network input on
the device (bicubic, as cv2's INTER_CUBIC), and either holds them in
memory (``source: memory``) or writes PNG frames and labelIds and reads
them back through the program's ``FileListDataset`` (``source: files``).
A warm pass runs every unit shape the traffic uses.

The window runs passes of ``pass_images`` images and closes at the first
unit whose records land after ``seconds``.  The benchmark's own code
stamps each unit's load start (the dataset's ``resized_batch``) and the
landing of its records (the writer's ``append_many``).

The check follows a sample of units, drawn from the seed, stage by stage
from the program's own state (the module ``reference/spalign.py``): the
SLIC maps against the reference's SLIC of the same images; the DRN
features against the reference's float32 DRN; the landed masks against
the reference's align, prior, k-means and paint run on the program's maps
and features with the draws of the unit's seeds; in a scored traffic, the
records' confusion counts against the reference scorer of the landed
masks.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import harness, pngw, scenes, weights
from perfbench.reference import drn as ref_drn
from perfbench.reference import spalign as ref
from perfbench.trace import Trace


class WindowClosed(Exception):
    """The first unit landed after the window's length: stop the pass."""


class Landing:
    """A result writer that stamps each unit's landing and closes the
    window at the first unit landing after ``deadline``.  It keeps a
    summary of each unit, and the records of the units in ``keep`` (by
    landing order): the window's records are not all held, so that the
    collector's work does not grow with the window."""

    def __init__(self, keep):
        self.deadline = float("inf")
        self.keep = set(keep)
        self.units = []  # summaries, in landing order
        self.records = {}  # landing order -> records, for ``keep``

    def append_many(self, records):
        t = time.perf_counter()
        first = records[0]
        if len(self.units) in self.keep:
            self.records[len(self.units)] = records
        self.units.append({
            "t": t, "images": len(records),
            "time_load": first.get("time_load"),
            "time_score": first.get("time_score"),
            "retries": first["retries"],
            "kmeans_iters": float(np.mean([r["kmeans_iters"]
                                           for r in records])),
            "unscored": sum(not np.isfinite(r.get("road_iou", np.nan))
                            for r in records)})
        if t >= self.deadline:
            raise WindowClosed


class Stamped:
    """The dataset the generator reads, with each unit's load start
    stamped: (time, indices) in load order."""

    def __init__(self, ds):
        self.ds = ds
        self.loads = []

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.ds.image_name(i)

    def label_name(self, i):
        return self.ds.label_name(i)

    def resized_batch(self, indices, hw):
        self.loads.append((time.perf_counter(), list(indices)))
        return self.ds.resized_batch(indices, hw)


class Memory:
    """In-memory network-size frames in the given order of scene indices,
    no GT."""

    def __init__(self, frames, order):
        self.frames, self.order = frames, order

    def __len__(self):
        return len(self.order)

    def image_name(self, i):
        return f"scene_{i:06d}.png"

    def label_name(self, i):
        return None

    def resized_batch(self, indices, hw):
        return self.frames[self.order[indices]], None


def resize_u8(frames: np.ndarray, hw, device) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, h, w, 3) uint8, bicubic (a = -0.75)
    without antialiasing, rounded, on ``device``."""
    out = []
    for i in range(0, len(frames), 8):
        x = torch.from_numpy(frames[i:i + 8]).to(device).permute(0, 3, 1, 2)
        y = F.interpolate(x.float(), size=tuple(hw), mode="bicubic",
                          align_corners=False)
        out.append(y.round().clamp(0, 255).to(torch.uint8)
                   .permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(out)


def label_config(cfg: dict):
    from spalign_tpu_torch.config import (AlignConfig, KMeansConfig,
                                          LabelGenConfig, PriorConfig,
                                          SuperpixelConfig)

    lg = dict(cfg["label_gen"])
    lg["resize_shape"] = tuple(lg["resize_shape"])
    lg["use_feature_maps"] = (cfg["model"]["feature_map"],)
    return LabelGenConfig(
        **lg, superpixel=SuperpixelConfig(**cfg["superpixel"]),
        prior=PriorConfig(**cfg["prior"]), align=AlignConfig(**cfg["align"]),
        kmeans=KMeansConfig(**cfg["kmeans"]), save_masks=False)


class Cell:
    def __init__(self, cfg, traffic, seed, device, chips=1):
        self.cfg, self.traffic, self.device, self.chips = (cfg, traffic,
                                                           device, chips)
        # the scenes and weights are the traffic's, whatever the seed: the
        # k-means work (its sweeps) follows them, and each seed has to
        # offer the same work; the seed orders the scenes in the passes,
        # seeds the program's host stream and draws the checked units
        self.scene_seed, self.weight_seed = harness.seeds(
            traffic["content_seed"], 2)
        self.order_seed, self.stream_seed, self.sample_seed = harness.seeds(
            seed, 3)
        self.tmp = None
        self.gen = None

    # --- set-up

    def setup(self) -> dict:
        from spalign_tpu_torch.data.cityscapes import FileListDataset
        from spalign_tpu_torch.pipeline.direct import make_label_generator

        tr, cfg, dev = self.traffic, self.cfg, self.device
        parts = {"builds": harness.build_libraries(tr["builds"])}
        t0 = time.perf_counter()
        hw = tuple(cfg["label_gen"]["resize_shape"])
        frames, self.label_ids = scenes.render(
            self.scene_seed, tr["scenes"], tuple(tr["frame_shape"]), dev)
        self.small = resize_u8(frames, hw, dev)
        n = len(frames)
        self.order = np.random.RandomState(self.order_seed).permutation(
            np.arange(tr["pass_images"]) % n)
        warm_order = np.arange(tr["warm_images"]) % n
        if tr["source"] == "memory":
            ds = Memory(self.small, self.order)
            warm = Memory(self.small, warm_order)
        else:
            self.tmp = tempfile.mkdtemp(prefix="perfbench-")

            def write(i):
                img = os.path.join(self.tmp, f"f{i:03d}_leftImg8bit.png")
                lab = os.path.join(self.tmp, f"f{i:03d}_labelIds.png")
                pngw.write_png(img, frames[i])
                pngw.write_png(lab, self.label_ids[i])
                return img, lab

            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(8) as pool:
                files = list(pool.map(write, range(len(frames))))

            def lists(order, tag):
                paths = []
                for k, col in enumerate(("img", "lab")):
                    p = os.path.join(self.tmp, f"{tag}_{col}.txt")
                    with open(p, "w") as f:
                        f.write("\n".join(files[i][k] for i in order)
                                + "\n")
                    paths.append(p)
                return FileListDataset(*paths, resize_shape=hw)

            ds = lists(self.order, "pass")
            warm = lists(warm_order, "warm")
        del frames
        parts["scenes_and_files"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        shapes = weights.drn_shapes(cfg["model"])
        self.sd = weights.make(shapes, self.weight_seed, dev, gain=1.0)
        self.gen = make_label_generator(
            label_config(cfg), state_dict=self.sd, seed=self.stream_seed,
            device=dev)
        self.sync()
        parts["model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.gen.process_dataset(warm, save=False)
        self.sync()
        parts["warm"] = time.perf_counter() - t0
        self.ds = Stamped(ds)
        return parts

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the window

    def _hook(self):
        """Wrap the generator's calls to record what the sampled units
        produced (maps, features, seeds, landed masks) and the size of
        every dispatch."""
        gen = self.gen
        rng = np.random.RandomState(self.sample_seed)
        sample = set(rng.choice(self.traffic["check_from"],
                                self.traffic["check_units"], replace=False)
                     .tolist())
        self.sample, self.captures, self.dispatches = sorted(sample), {}, []
        state = {"next": 0, "cap": None}
        dispatch, run_unit, features, finish = (
            gen.dispatch_batch, gen.run_unit, gen.features, gen.finish_batch)

        def on_dispatch(prepared, timers):
            if "_perfbench_unit" not in prepared:
                prepared["_perfbench_unit"] = state["next"]
                state["next"] += 1
            k = prepared["_perfbench_unit"]
            self.dispatches.append(int(prepared["wire"].shape[0]))
            state["cap"] = {"unit": k} if k in sample else None
            try:
                handles = dispatch(prepared, timers)
            finally:
                cap, state["cap"] = state["cap"], None
            if cap is not None:
                handles["_perfbench"] = cap
            return handles

        def on_run_unit(wire, seeds, *a, **kw):
            out = run_unit(wire, seeds, *a, **kw)
            if state["cap"] is not None:
                state["cap"]["seeds"] = [int(s) for s in seeds]
                state["cap"]["superpixels"] = out["superpixels"].clone()
            return out

        def on_features(images):
            out = features(images)
            if state["cap"] is not None:
                state["cap"]["features"] = out.clone()
            return out

        def on_finish(prepared, handles, timers):
            res = finish(prepared, handles, timers)
            cap = handles.get("_perfbench")
            if cap is not None:
                cap["road_packed"] = np.array(handles["host"]["road_packed"])
                self.captures[cap["unit"]] = cap
            return res

        gen.dispatch_batch, gen.run_unit = on_dispatch, on_run_unit
        gen.features, gen.finish_batch = on_features, on_finish

    def window(self, seconds: float, trace: bool):
        self._hook()
        land = self.landing = Landing(self.sample)
        self.ds.loads = []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        with Trace(trace, self.device) as t:
            self.t0 = time.perf_counter()
            land.deadline = self.t0 + seconds
            try:
                while True:
                    self.gen.process_dataset(self.ds, save=False,
                                             writer=land)
            except WindowClosed:
                pass
            self.t_close = land.units[-1]["t"]
            self.sync()
            t.close_window()
        harness.log(
            f"window: {len(land.units)} units, k-means sweeps a group "
            f"{np.mean([u['kmeans_iters'] for u in land.units]):.2f} (mean "
            f"over units), {sum(u['retries'] for u in land.units)} "
            f"retries, {len(self.dispatches)} dispatches")
        return t.summary() if trace else None

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def attempted(self) -> int:
        return sum(u["images"] for u in self.landing.units)

    def end_to_end(self) -> dict:
        units = self.landing.units
        loads = self.ds.loads
        lat = [(u["t"] - loads[i][0]) * 1e3 for i, u in enumerate(units)]
        return {"label_images_per_s": self.attempted()
                / (self.t_close - self.t0),
                "label_unit_p95_ms": float(np.percentile(lat, 95))}

    def layer_run(self, trace_summary):
        return SimpleNamespace(
            kind="label", cfg=self.cfg, traffic=self.traffic,
            chips=self.chips, trace=trace_summary,
            images=self.attempted(),
            units=list(self.landing.units),
            dispatches=list(self.dispatches))

    # --- the check

    def _images(self, indices) -> np.ndarray:
        return self.small[self.order[indices]]

    def check(self, limits: dict, readings: bool):
        """Numbers compared, each the worst over the sampled images, with
        its limit; the count of sampled images over a limit; and (with
        ``readings``) the controls' readings of the same numbers."""
        cfg, dev = self.cfg, self.device
        self.gen = None  # the program's state goes before the reference
        gc.collect()  # the hooks hold the generator in a cycle
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        sp = cfg["superpixel"]
        hw = tuple(cfg["label_gen"]["resize_shape"])
        # slic_px, feat_rel and score_mismatch: the worst sampled image;
        # mask_px: the share over every sampled image (one image's worst
        # swings by a whole superpixel, 0.3-1% of its pixels, where the
        # program and the reference part on a float32 near-tie of the
        # k-means distances)
        worst = {"slic_px": 0.0, "feat_rel": 0.0}
        masks, c_masks = [], []
        if self.traffic["scored"]:
            worst["score_mismatch"] = 0.0
        ctrl = {k: [] for k in ("slic_px", "feat_rel")}
        bad = set()  # (unit, row) of the sampled images over a limit
        lost = 0  # sampled units that never landed: an answer never came
        for k in self.sample:
            cap = self.captures.get(k)
            if cap is None:
                harness.log(f"sampled unit {k} never landed")
                lost += 1
                continue
            idx = self.ds.loads[k][1]
            rgb = ref.decode_yuv420(torch.from_numpy(ref.pack_yuv420(
                self._images(idx))).to(dev), hw)
            sps = cap["superpixels"].long()
            r_sp = ref.slic(rgb, sp["n_slic_segments"],
                            sp["slic_compactness"], sp["slic_iters"])
            v = (r_sp != sps).flatten(1).float().mean(1)
            self._worst(worst, "slic_px", v, limits, k, bad)
            r_f = ref_drn.features(self.sd, cfg["model"], rgb)
            p_f = cap["features"]
            v = ((p_f - r_f).flatten(1).norm(dim=1)
                 / r_f.flatten(1).norm(dim=1))
            self._worst(worst, "feat_rel", v, limits, k, bad)
            r_m = ref.masks(p_f, sps, cap["seeds"], cfg)
            p_m = torch.from_numpy(np.unpackbits(
                cap["road_packed"], axis=-1)[..., :hw[1]].astype(bool)).to(
                dev)
            masks.append((k, (r_m != p_m).flatten(1).float().mean(1).cpu()))
            if self.traffic["scored"]:
                recs = self.landing.records[k]
                pm = p_m.cpu().numpy()
                v = torch.tensor([
                    float(ref.confusion(pm[j], self.label_ids[
                        self.order[i]]) != (r["TP"], r["FP"], r["FN"]))
                    for j, (i, r) in enumerate(zip(idx, recs))])
                self._worst(worst, "score_mismatch", v, limits, k, bad)
            if readings:
                c_sp = ref.slic(rgb, sp["n_slic_segments"],
                                sp["slic_compactness"], sp["slic_iters"],
                                score_dtype=torch.bfloat16)
                ctrl["slic_px"].append(float(
                    (c_sp != r_sp).flatten(1).float().mean(1).max()))
                c_f = ref_drn.features(self.sd, cfg["model"], rgb,
                                       quant="fp8")
                ctrl["feat_rel"].append(float(
                    ((c_f - r_f).flatten(1).norm(dim=1)
                     / r_f.flatten(1).norm(dim=1)).max()))
                c_m = ref.masks(p_f, sps, cap["seeds"], cfg, tf32=True)
                c_masks.append((c_m != r_m).flatten(1).float().mean(1).cpu())
        # every scene has road, so every scored record has a road IoU
        unscored = sum(u["unscored"] for u in self.landing.units
                       ) if self.traffic["scored"] else 0
        per_image = torch.cat([v for _, v in masks]) if masks else None
        worst["mask_px"] = float(per_image.mean()) if masks else 0.0
        if worst["mask_px"] > limits["mask_px"]:
            bad.update((k, j) for k, v in masks
                       for j in np.nonzero(v.numpy() > 0)[0])
        checks = {n: {"value": worst[n], "limit": float(limits[n])}
                  for n in limits}
        reads = {}
        if readings:
            reads = {n: max(v) for n, v in ctrl.items() if v}
            if c_masks:
                reads["mask_px"] = float(torch.cat(c_masks).mean())
                reads["control_mask_px_max"] = float(torch.cat(c_masks).max())
            if masks:
                reads["program_mask_px_max"] = float(per_image.max())
        unit = self.cfg["label_gen"]["batchsize"] * self.cfg["label_gen"][
            "groups_per_dispatch"]
        return checks, len(bad) + lost * unit + unscored, reads

    @staticmethod
    def _worst(worst, name, per_image, limits, unit, bad):
        """Fold one unit's per-image readings into the worst, and mark the
        unit's images over the limit (an image counts once)."""
        v = per_image.cpu().double().numpy()
        worst[name] = max(worst[name], float(v.max()))
        bad.update((unit, j) for j in np.nonzero(v > limits[name])[0])

    def close(self):
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
