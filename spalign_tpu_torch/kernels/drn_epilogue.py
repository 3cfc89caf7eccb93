"""The folded DRN's epilogue: bias, residual and ReLU in one in-place pass
over a convolution output, a Hopper kernel and its plain version.

``drn_epilogue(y, bias, residual=None)`` computes

    y = relu((y + bias) + residual)

in float32, in that order, rounds once to y's type and writes y in place.
y is (N, C, H, W), bfloat16 or float32; bias (C,) float32; the residual,
when given, y's shape, type and layout.  CUDA tensors launch
``csrc/drn_epilogue.cu`` on the current stream (y channels_last, C a
multiple of 16 bytes of y's type); CPU tensors take the plain version
``drn_epilogue_reference``, any layout.  It replaces no TPU kernel: the
JAX package's DRN leaves BN, ReLU and the add to XLA (the source's note).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary("drn_epilogue", {
    # (y, bias, residual or NULL, pixels = N*H*W, C, dtype, stream)
    "spalign_drn_epilogue": (ctypes.c_int, [_P, _P, _P, _L, _L, _I, _P]),
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(y: torch.Tensor, bias: torch.Tensor,
           residual: Optional[torch.Tensor]):
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be bfloat16 or float32, got {y.dtype}")
    c = y.shape[1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be float32 ({c},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if residual is not None and (residual.dtype != y.dtype
                                 or residual.shape != y.shape):
        raise ValueError(f"residual must be y's {y.dtype} "
                         f"{tuple(y.shape)}, got {residual.dtype} "
                         f"{tuple(residual.shape)}")
    for t in (bias,) if residual is None else (bias, residual):
        if t.device != y.device:
            raise ValueError("bias and residual must lie on y's device")


def drn_epilogue(y: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = relu((y + bias) + residual) in place (module docstring);
    returns y."""
    _check(y, bias, residual)
    if y.device.type == "cpu":
        return y.copy_(drn_epilogue_reference(y, bias, residual))
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    vec = 16 // y.element_size()
    if y.shape[1] % vec:
        raise ValueError(f"C = {y.shape[1]} must be a multiple of {vec} "
                         f"for {y.dtype}")
    cl = torch.channels_last
    for name, t in (("y", y), ("residual", residual)):
        if t is not None and not t.is_contiguous(memory_format=cl):
            raise ValueError(f"{name} must be channels_last contiguous")
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    for t in (y, bias, residual):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("tensors must be 16-byte aligned")
    if y.numel() == 0:
        return y
    n, c, h, w = y.shape
    fn = LIBRARY.get().spalign_drn_epilogue
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 n * h * w, c, _DTYPES[y.dtype], stream)
    if err != 0:
        raise RuntimeError(f"spalign_drn_epilogue launch failed: CUDA "
                           f"error {err}")
    drn_epilogue.launches += 1
    return y


# kernel launches, for proof of the path taken
drn_epilogue.launches = 0


def drn_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version: the kernel's float32 arithmetic in its order,
    one rounding to y's type; a new tensor."""
    v = y.to(torch.float32) + bias.reshape(1, -1, 1, 1)
    if residual is not None:
        v = v + residual.to(torch.float32)
    return torch.relu(v).to(y.dtype)
