"""Label-generation cells whose backbone is a DRN-D with bottleneck blocks
(DRN-D-105): ``drivers/label.py``'s cell with three things changed, the
weights (``weights_drn_d.py``'s table), the network's name passed to the
program's ``make_label_generator`` (the configuration's ``model.arch``),
and the features the check compares with (``reference/drn_d.py``).
Everything else, the window, its stamps, the end-to-end metrics and the
rest of the check, is ``label.Cell``'s.  The frames are held in memory
(``source: memory``).
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import harness, scenes, weights, weights_drn_d
from perfbench.drivers import label
from perfbench.reference import drn_d as ref_drn_d


class Cell(label.Cell):
    def setup(self) -> dict:
        """``label.Cell.setup`` of an in-memory traffic, with the D
        weights and the network's name."""
        from spalign_tpu_torch.pipeline.direct import make_label_generator

        tr, cfg, dev = self.traffic, self.cfg, self.device
        if tr["source"] != "memory":
            raise ValueError(f"source {tr['source']!r}: the DRN-D cells "
                             f"hold their frames in memory")
        parts = {"builds": harness.build_libraries(tr["builds"])}
        t0 = time.perf_counter()
        frames, _ = scenes.render(
            self.scene_seed, tr["scenes"], tuple(tr["frame_shape"]), dev)
        self.small = label.resize_u8(
            frames, tuple(cfg["label_gen"]["resize_shape"]), dev)
        del frames
        n = len(self.small)
        self.order = np.random.RandomState(self.order_seed).permutation(
            np.arange(tr["pass_images"]) % n)
        parts["scenes_and_files"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.sd = weights.make(weights_drn_d.drn_d_shapes(cfg["model"]),
                               self.weight_seed, dev, gain=1.0)
        self.gen = make_label_generator(
            label.label_config(cfg), state_dict=self.sd,
            model_name=cfg["model"]["arch"], seed=self.stream_seed,
            device=dev)
        self.sync()
        parts["model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.gen.process_dataset(
            label.Memory(self.small, np.arange(tr["warm_images"]) % n),
            save=False)
        self.sync()
        parts["warm"] = time.perf_counter() - t0
        self.ds = label.Stamped(label.Memory(self.small, self.order))
        return parts

    def check(self, limits: dict, readings: bool):
        """``label.Cell.check`` with the D reference's features: that
        check reads them, float32 and the fp8 control alike, through its
        module's ``ref_drn``, which the D reference stands in for while it
        runs."""
        saved, label.ref_drn = label.ref_drn, ref_drn_d
        try:
            return super().check(limits, readings)
        finally:
            label.ref_drn = saved
