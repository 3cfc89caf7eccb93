"""Flax DRN and SegNet variables -> the port's state_dicts.

The inverse of ``spalign_tpu/convert/pth_to_jax.py::convert_drn_state_dict``:
conv kernels HWIO -> OIHW, BatchNorm ``scale``/``bias`` (params) and
``mean``/``var`` (batch_stats) -> ``weight``/``bias``/``running_mean``/
``running_var``, and the flax module paths -> the port's module names
(which are the public checkpoints' names).  Takes the variables as a
nested dict of numpy arrays (``jax.device_get`` of them is one) and never
imports jax.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def _walk(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_name(path: tuple, arch: str) -> str:
    """flax module path (without the leaf) -> torch module name."""
    head = path[0]
    if head in ("conv1", "bn1", "fc"):
        return head
    if not re.fullmatch(r"layer\d+", head):
        raise ValueError(f"unexpected flax path {'/'.join(path)}")
    lnum = int(head[5:])
    if arch == "D" and lnum in (0, 1, 2, 7, 8):
        # conv-bn-relu stacks: convI -> 3I, bnI -> 3I+1
        m = re.fullmatch(r"(conv|bn)(\d+)", path[1])
        if m is None or len(path) != 2:
            raise ValueError(f"unexpected flax path {'/'.join(path)}")
        return f"{head}.{3 * int(m.group(2)) + (m.group(1) == 'bn')}"
    m = re.fullmatch(r"block(\d+)", path[1])
    if m is None or len(path) != 3:
        raise ValueError(f"unexpected flax path {'/'.join(path)}")
    sub = {"downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}.get(path[2], path[2])
    return f"{head}.{m.group(1)}.{sub}"


def drn_state_dict_from_flax(variables, arch: str = "C"
                             ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} -> state_dict for the port's
    ``DRN`` of the same architecture (float32, CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, v in _walk(variables.get(collection, {})):
            name = _module_name(path[:-1], arch)
            leaf = path[-1]
            if leaf == "kernel":
                key, v = f"{name}.weight", v.transpose(3, 2, 0, 1)
            elif (collection, leaf) in _BN_LEAVES and name != "fc":
                key = f"{name}.{_BN_LEAVES[(collection, leaf)]}"
            elif leaf == "bias" and name == "fc":
                key = "fc.bias"
            else:
                raise ValueError(f"unexpected flax leaf {collection}/"
                                 f"{'/'.join(path)}")
            _put(out, key, v)
    return out


def _put(out: dict, key: str, v: np.ndarray):
    out[key] = torch.from_numpy(np.array(v, dtype=np.float32))
    if key.endswith(".running_var"):
        out[key[:-len("running_var")] + "num_batches_tracked"] = (
            torch.tensor(0, dtype=torch.int64))


_SEGNET_TOP = {"basic": re.compile(r"conv(_decode)?[1-4](_bn)?|conv_classifier"),
               "normal": re.compile(r"(up_)?block[1-5]|score")}


def segnet_state_dict_from_flax(variables, model: str = "basic"
                                ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the flax SegNetBasic
    ('basic') or SegNet ('normal') -> state_dict of the port's module
    (``models/segnet.py``, whose module names are the flax paths joined
    with '.').  Kernels HWIO -> OIHW; BN scale/bias/mean/var ->
    weight/bias/running_mean/running_var; conv biases stay biases."""
    if model not in _SEGNET_TOP:
        raise ValueError(f"unknown model {model!r}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, v in _walk(variables.get(collection, {})):
            if not _SEGNET_TOP[model].fullmatch(path[0]):
                raise ValueError(f"unexpected flax path {'/'.join(path)} "
                                 f"for model={model!r}")
            name, leaf = ".".join(path[:-1]), path[-1]
            if leaf == "kernel":
                key, v = f"{name}.weight", v.transpose(3, 2, 0, 1)
            elif (collection, leaf) in _BN_LEAVES:
                key = f"{name}.{_BN_LEAVES[(collection, leaf)]}"
            else:
                raise ValueError(f"unexpected flax leaf {collection}/"
                                 f"{'/'.join(path)}")
            _put(out, key, v)
    return out
