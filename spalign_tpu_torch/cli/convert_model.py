"""Model conversion CLI: a DRN ``.pth`` checkpoint -> the port's DRN
weights, with the structural and numeric checks (replaces
models/convert_pth2ch.py).

Counterpart of ``spalign_tpu/cli/convert_model.py``.  The port's DRN
keeps the public checkpoints' module names, so the conversion is a
check: the file loads strictly into ``DRN_FACTORIES[--model]`` (a
mismatch raises, naming the missing and unexpected keys and the shape
mismatches), and its float32 state_dict is saved to ``out_path``, a
``.pth`` that the port's ``--weights`` takes.  The JAX package writes a
``.pytree`` (a pickled jax treedef) there, which the port cannot read;
flax weights come over with ``spalign_tpu_torch.convert.from_jax``.
``--check`` runs the DRN on ``--device`` (float32, TF32 off) and on the
CPU and holds the output and the eight stage maps within rtol 1e-3,
atol 1e-4.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from spalign_tpu_torch.cli.common import load_pth
from spalign_tpu_torch.models.drn import DRN_FACTORIES
from spalign_tpu_torch.utils.device import full_float32, resolve_device


def load_checked(pth_path: str, model_name: str = "drn_c_26") -> dict:
    """The checkpoint's state_dict, checked against the port's DRN: the
    same keys and shapes, or ValueError naming the differences."""
    state = load_pth(pth_path)
    want = DRN_FACTORIES[model_name](device="cpu").state_dict()
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    shapes = [f"{k}: checkpoint {tuple(state[k].shape)} vs model "
              f"{tuple(want[k].shape)}" for k in sorted(set(want) & set(state))
              if tuple(state[k].shape) != tuple(want[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(f"{pth_path} does not fit {model_name}: "
                         f"missing={missing[:8]} unexpected={unexpected[:8]} "
                         f"shape mismatches={shapes[:8]}")
    return {k: (v.to(torch.float32) if v.is_floating_point() else v)
            for k, v in state.items()}


def check_forward(state: dict, model_name: str, device) -> float:
    """The DRN with ``state`` on ``device`` against the CPU on
    RandomState(0)'s (1, 64, 64, 3) input: output and the eight maps
    within rtol 1e-3, atol 1e-4.  Returns the largest difference."""
    dev = resolve_device(device)
    full_float32(dev)
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        model = DRN_FACTORIES[model_name](device="cpu")
        model.load_state_dict(state, strict=True)
        model = model.to(d).eval()
        with torch.no_grad():
            out, maps = model(torch.from_numpy(x).to(d))
        outs.append([t.float().cpu().numpy() for t in (out, *maps)])
    worst = 0.0
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pth_path", type=str)
    p.add_argument("out_path", type=str,
                   help="the port's .pth (a float32 state_dict); not the "
                        "JAX package's .pytree, which the port cannot read")
    p.add_argument("--model", type=str, default="drn_c_26")
    p.add_argument("--check", action="store_true", default=False,
                   help="run the converted DRN on --device and on the CPU "
                        "and compare (rtol 1e-3, atol 1e-4)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)

    state = load_checked(args.pth_path, args.model)
    torch.save(state, args.out_path)
    print(f"converted {args.pth_path} -> {args.out_path}")
    worst = None
    if args.check:
        worst = check_forward(state, args.model, args.device)
        print(f"parity check passed (<=1e-4; max |delta| {worst:.3g})")
    return worst


if __name__ == "__main__":
    main()
