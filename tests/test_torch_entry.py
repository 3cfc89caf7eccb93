"""The port's entry points (spalign_tpu_torch/entry.py), the counterparts
of __graft_entry__.py: ``entry()`` against the forward of the JAX
package's ``entry()`` (the flax DRN-C-26's stage-8 map of its example
images; the weights initialised under jit, as ``entry()``'s un-jitted
init takes ~25 s on the CPU) on the same weights, and
``dryrun_multichip`` on gloo CPU ranks, in this process and in a cold
subprocess (tests/test_graft_entry.py's pair): each of its five parts
(the train step, the cluster path, the fused SLIC path, the direct and
overlaps generators, two self-training rounds).

Tolerance: the stage-8 map within 1e-4 of its largest |value| in float32
(the converter's bar, tests/test_torch_drn.py).  The dry run holds its
ranks to one rank itself (entry.py states its bar)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spalign_tpu.models import drn_c_26, preprocess_imagenet
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.entry import dryrun_multichip, entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def test_entry_forward_equals_jax():
    model_j = drn_c_26(out_map=True, out_middle=True)
    variables = jax.jit(model_j.init)(jax.random.key(0),
                                      jnp.zeros((1, 224, 224, 3)))
    images = jnp.asarray(np.random.RandomState(0).randint(
        0, 255, (2, 224, 224, 3)), jnp.float32)  # __graft_entry__'s

    @jax.jit
    def forward_j(variables, images):  # __graft_entry__.entry's forward
        _, maps = model_j.apply(variables, preprocess_imagenet(images),
                                train=False)
        return maps[7]

    want = np.asarray(forward_j(variables, images))  # (2, 28, 28, 512)
    forward, (model, x) = entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(images))
    model.load_state_dict(drn_state_dict_from_flax(
        jax.device_get(variables), arch="C"), strict=True)
    got = forward(model, x)
    assert got.shape == (2, 512, 28, 28)
    assert bool(torch.isfinite(got).all())
    want = want.transpose(0, 3, 1, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_dryrun_multichip_2():
    """Each of the JAX dry run's five parts ran over 2 ranks and held to
    one rank (the rounds to JAX's checks)."""
    out = dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and out["device"] == "cpu"
    step = out["train_step"]
    assert np.isfinite(step["loss"]) and np.isfinite(step["grad_norm"])
    for part in ("cluster", "fused_slic"):
        assert out[part]["masks_equal"] and out[part]["shape"] == [2, 32, 32]
    for part in ("direct", "overlaps"):
        assert out[part]["masks_equal"] and out[part]["images"] == 2
        assert np.isfinite(out[part]["road_iou"])
    rounds = out["rounds"]
    assert rounds["rounds"] == 2 and len(rounds["losses"]) == 2
    assert all(np.isfinite(rounds["losses"]))
    assert rounds["losses"][0] != rounds["losses"][-1]
    assert rounds["final_zip"] == "iter-4_eval-train.0.zip"
    for part in ("train_step", "cluster", "fused_slic", "direct",
                 "overlaps", "rounds"):
        assert out[part]["seconds"] > 0, part
    # the CPU runs the kernels' plain versions: no launch in any rank
    assert set(out["rank_launches"].values()) == {0}


def test_dryrun_multichip_cold_process():
    """A fresh interpreter, as a user would call it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c",
         "from spalign_tpu_torch.entry import dryrun_multichip\n"
         "dryrun_multichip(2, device='cpu')\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip(2): ok" in proc.stdout
    for part in ("train_step", "cluster", "fused_slic", "direct",
                 "overlaps", "rounds"):
        assert f"  {part}: ok" in proc.stdout, part
