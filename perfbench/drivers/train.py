"""Training cells: ``Trainer.train_step`` fed by the program's loader
(``PrefetchLoader`` over ``EstimatedCityscapesDataset``), closed loop, on
one card or data-parallel over ``ranks`` cards (one process a card).

Set-up renders the traffic's scenes, writes each as a PNG frame with a
``.npy`` road mask from its own labelIds (standing in for the pseudo-
label), makes the weights on the device from the seed, builds one
``Trainer`` on them and drives it through its first ``check_steps`` steps
by the window's own call and feed: those steps are the warm-up and what
the check compares.  It keeps the losses, the first gradient as Adam
holds it after step 1 (``exp_avg / (1 - beta1)``), the parameters before
step ``check_steps + 1``, and a hash of each label row fed, which names
its scene.

Over several ranks the harness's process is rank 0: it starts the other
ranks (``perfbench/rank.py``), joins them in a process group (NCCL on
cards, gloo on the CPU) and a gloo group for control, and alone renders
and writes the files.  Each rank's loader yields its rows of every global
batch.  A step ends, on every rank, with rank 0's word whether the window
goes on.

The window runs steps until ``seconds`` have passed and ends with a
synchronize.  The reference (``reference/segnet.py``) follows the checked
steps on the global batches from the same weights, on one card, after the
program's state is freed.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from perfbench import harness, pngw, scenes, weights
from perfbench.reference import segnet as ref
from perfbench.trace import Trace


def _row_hash(row: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(row, np.int32).tobytes(),
                           digest_size=16).hexdigest()


class Cell:
    # a ``module:function`` the other ranks call before their set-up (the
    # tests plant a fault there)
    worker_hook = None

    def __init__(self, cfg, traffic, seed, device, chips=1, rank=0):
        self.cfg, self.traffic, self.chips = cfg, traffic, chips
        self.seed, self.rank = seed, rank
        self.world = int(traffic.get("ranks", 1))
        if device.type == "cuda" and self.world > 1:
            device = torch.device("cuda", rank)
        self.device = device
        self.scene_seed, self.weight_seed, self.loader_seed = harness.seeds(
            seed, 3)
        self.tmp = None
        self.trainer = None
        self.loader_it = None
        self.workers = []
        self.ctrl = None

    # --- the process group

    def _spawn_and_join(self):
        """Rank 0: start ranks 1.. and join them all in a process group."""
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        spec = os.path.join(self.tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"config": self.cfg, "traffic": self.traffic,
                       "chips": self.chips}, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for r in range(1, self.world):
            cmd = [sys.executable, str(harness.HERE / "rank.py"),
                   "--spec", spec, "--seed", str(self.seed), "--rank",
                   str(r), "--port", str(port), "--device",
                   self.device.type]
            if self.worker_hook:
                cmd += ["--hook", self.worker_hook]
            self.workers.append(subprocess.Popen(cmd, cwd=harness.REPO,
                                                 stdout=sys.stderr))
        self.join(port)

    def join(self, port: int):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=self.world,
            rank=self.rank)
        self.ctrl = dist.new_group(backend="gloo")

    def _bcast(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self.ctrl)
        return box[0]

    def _gather(self, obj):
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, 0, group=self.ctrl)
        return out

    # --- set-up

    def _write_files(self) -> str:
        """Rank 0: render the scenes and write them; the directory."""
        tr = self.traffic
        self.frames, label_ids = scenes.render(
            self.scene_seed, tr["scenes"], tuple(tr["frame_shape"]),
            self.device)
        self.road = (label_ids == 7).astype(np.uint8)
        del label_ids
        if self.tmp is None:
            self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        data = os.path.join(self.tmp, "data")
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(data, sub))

        def write(i):
            pngw.write_png(os.path.join(data, "images", f"f{i:03d}.png"),
                           self.frames[i])
            np.save(os.path.join(data, "labels", f"f{i:03d}.npy"),
                    self.road[i])

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write, range(len(self.frames))))
        return data

    def setup(self) -> dict:
        from spalign_tpu_torch.config import TrainConfig
        from spalign_tpu_torch.data.estimated import \
            EstimatedCityscapesDataset
        from spalign_tpu_torch.data.loader import PrefetchLoader
        from spalign_tpu_torch.models.segnet import build_segnet
        from spalign_tpu_torch.train.trainer import Trainer

        tr, cfg, dev = self.traffic, self.cfg, self.device
        model_cfg, opt = cfg["model"], cfg["optimizer"]
        parts = {"builds": harness.build_libraries(tr["builds"])}
        t0 = time.perf_counter()
        if self.world > 1 and self.rank == 0:
            self._spawn_and_join()
        parts["ranks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = self._write_files() if self.rank == 0 else None
        if self.world > 1:
            data = self._bcast(data)
        parts["scenes_and_files"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hw = tuple(cfg["input_shape"])
        self.sd = weights.make(weights.segnet_shapes(model_cfg),
                               self.weight_seed, dev, gain=2.0 ** 0.5)
        model = build_segnet(model_cfg["name"], model_cfg["n_class"],
                             device=dev)
        model.load_state_dict(self.sd, strict=True)
        tcfg = TrainConfig(
            model=model_cfg["name"], n_class=model_cfg["n_class"],
            batchsize=cfg["batchsize"], optimizer=opt["name"],
            loss=cfg["loss"], input_shape=hw,
            compute_dtype=cfg["compute_dtype"],
            result_dir=os.path.join(data, f"result{self.rank}"))
        self.trainer = Trainer(tcfg, model=model, device=dev)
        ds = EstimatedCityscapesDataset(os.path.join(data, "images"),
                                        os.path.join(data, "labels"), hw)
        self.loader = PrefetchLoader(ds, cfg["batchsize"], shuffle=True,
                                     num_workers=tr["loader_workers"],
                                     prefetch=tr["prefetch"],
                                     seed=self.loader_seed, rank=self.rank,
                                     world=self.world)
        self.loader_it = iter(self.loader)
        parts["model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._first_steps(opt)
        parts["warm"] = time.perf_counter() - t0
        return parts

    def _first_steps(self, opt):
        """The check's steps, by the window's call and feed."""
        trainer = self.trainer
        self.losses, self.fed = [], []
        for s in range(self.traffic["check_steps"]):
            images, labels = next(self.loader_it)
            out = trainer.train_step(*trainer.to_device(images, labels))
            self.losses.append(float(out["loss"]))
            self.fed.append([_row_hash(row) for row in labels])
            if s == 0:
                self.grad1 = {
                    n: (trainer.optimizer.state[p]["exp_avg"]
                        / (1.0 - opt["beta1"])).clone()
                    for n, p in trainer.model.named_parameters()}
        self.params = {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}
        if self.world > 1:
            parts = self._gather(self.fed)
            if self.rank == 0:  # rows of each global batch in rank order
                self.fed = [[h for part in parts for h in part[s]]
                            for s in range(len(self.fed))]
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the window

    def _go_on(self, go: bool) -> bool:
        """Rank 0's word, on every rank, whether the window goes on."""
        if self.world == 1:
            return go
        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=self.ctrl)
        return bool(flag.item())

    def window(self, seconds: float, trace: bool):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.waits, losses = [], []
        if self.world > 1:
            dist.barrier(group=self.ctrl)
        with Trace(trace and self.rank == 0, self.device) as t:
            self.t0 = time.perf_counter()
            while self._go_on(time.perf_counter() - self.t0 < seconds):
                a = time.perf_counter()
                images, labels = next(self.loader_it)
                self.waits.append(time.perf_counter() - a)
                out = self.trainer.train_step(
                    *self.trainer.to_device(images, labels))
                losses.append(out["loss"])
            self.sync()
            self.t_end = time.perf_counter()
            t.close_window()
        self.steps = len(losses)
        self.nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        self.peaks = self._gather(peak) if self.world > 1 else [peak]
        return t.summary() if trace and self.rank == 0 else None

    def memory_peak(self) -> int:
        """The fullest card's peak."""
        return max(self.peaks)

    def attempted(self) -> int:
        return self.steps

    def end_to_end(self) -> dict:
        """The global images a second, under the traffic's metric name."""
        return {self.traffic["rate_metric"]: self.cfg["batchsize"]
                * self.steps / (self.t_end - self.t0)}

    def layer_run(self, trace_summary):
        return SimpleNamespace(kind="train", cfg=self.cfg,
                               traffic=self.traffic, chips=self.chips,
                               trace=trace_summary, steps=self.steps,
                               waits=list(self.waits))

    # --- the check

    def _free_program(self):
        if self.loader_it is not None:
            self.loader_it.close()
            self.loader_it = None
        self.trainer = None
        if self.ctrl is not None:
            dist.barrier(group=self.ctrl)  # every rank is past its window
            dist.destroy_process_group()
            self.ctrl = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict, readings: bool):
        """loss1_gap: the first step's |loss - reference| / |reference|;
        grad_gap and update_gap: the worst leaf's gap between the norms of
        the first gradient and of the parameters' change after the checked
        steps, over the larger of the reference leaf's norm and the median
        leaf's (leaves whose reference gradient is under a thousandth of
        the median leaf's are left out of the change).  The limits file
        names the numbers compared; the readings carry every step's."""
        self._free_program()
        cfg, dev = self.cfg, self.device
        hw = tuple(cfg["input_shape"])
        small = ref.nearest(self.road, hw)
        scene_of = {_row_hash(row): i for i, row in enumerate(small)}
        batches = [[scene_of.get(h, -1) for h in step] for step in self.fed]
        failed = sum(i < 0 for b in batches for i in b)
        if failed:
            harness.log(f"{failed} fed label rows match no scene")
            batches = [[max(i, 0) for i in b] for b in batches]

        def inputs(ids):
            return ref.inputs(self.frames[ids], small[ids], hw, cfg, dev)

        r = ref.train_steps(self.sd, cfg, [inputs(b) for b in batches])
        p = {"losses": self.losses, "grad1": self.grad1,
             "params": self.params}
        got = ref.gaps(p, r, self.sd)
        checks = {n: {"value": got[n], "limit": float(limits[n])}
                  for n in limits}
        failed += self.nonfinite
        reads = {"program": got}
        if readings:
            reads["tf32"] = ref.gaps(ref.train_steps(
                self.sd, cfg, [inputs(b) for b in batches], tf32=True), r,
                self.sd)
            half = [inputs(b[:len(b) // 2]) for b in batches]
            reads["half_batch"] = ref.gaps(ref.train_steps(
                self.sd, cfg, half), r, self.sd)
        return checks, failed, reads

    def close(self):
        if self.loader_it is not None:
            self.loader_it.close()
            self.loader_it = None
        # a run cut short leaves the other ranks in a collective: end them
        for w in self.workers:
            if self.ctrl is not None:
                w.kill()
            try:
                w.wait(timeout=60)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
        if self.ctrl is not None:
            dist.destroy_process_group()
            self.ctrl = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
