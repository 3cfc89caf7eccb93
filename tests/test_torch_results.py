"""The port's result records (spalign_tpu_torch/eval/results.py) against
the JAX package's: ``ResultWriter.append`` writes the same bytes, record
by record, as ``spalign_tpu.eval.results.ResultWriter.append``, and
``append_many`` the same as a run of ``append``."""

import numpy as np
import pytest

from spalign_tpu.eval.results import ResultWriter as JaxResultWriter
from spalign_tpu_torch.eval.results import ResultWriter

RECORDS = {
    "plain": {"img_fn": "a_leftImg8bit.png", "road_iou": 0.5, "TP": 3,
              "precision": None},
    "numpy": {"img_fn": "b.png", "TP": np.int64(7), "iou": np.float32(0.25),
              "counts": np.arange(3, dtype=np.int32), "nan": float("nan")},
    "nested": {"cfg": {"k": 4, "shape": (224, 224)}, "name": object.__name__,
               "flags": [True, False], "path": np.str_("x/y")},
}


@pytest.mark.parametrize("name", list(RECORDS))
def test_append_byte_equal_to_jax(tmp_path, name):
    rec = RECORDS[name]
    port = ResultWriter(str(tmp_path / "port"))
    jax_w = JaxResultWriter(str(tmp_path / "jax"))
    for _ in range(2):  # appends, never truncates
        port.append(rec)
        jax_w.append(rec)
    with open(port.path, "rb") as f, open(jax_w.path, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and got.count(b"\n") == 2


def test_append_many_equals_appends(tmp_path):
    a = ResultWriter(str(tmp_path), "a.json")
    b = ResultWriter(str(tmp_path), "b.json")
    a.append_many(RECORDS.values())
    for rec in RECORDS.values():
        b.append(rec)
    with open(a.path, "rb") as f, open(b.path, "rb") as g:
        assert f.read() == g.read()
