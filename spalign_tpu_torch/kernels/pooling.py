"""SegNet's 2x2 argmax pool and index unpool: Hopper kernels, their plain
versions and their autograd functions.

Counterpart of ``spalign_tpu/kernels/pooling_pallas.py``.  The three
wrappers ``pool2x2``, ``scatter2x2`` and ``gather2x2`` launch
``csrc/pooling.cu`` for CUDA tensors and run the plain versions
(``*_reference``) only for CPU tensors.  Layout: contiguous NHWC, float32
or bfloat16; codes are int8 ``2*dy + dx`` in [0, 4), the first maximum of
the window in (dy, dx) order (Chainer's rule).

  pool2x2:    x (N, 2h, 2w, C) -> pooled (N, h, w, C), codes (N, h, w, C)
  scatter2x2: x (N, h, w, C), codes -> (N, 2h, 2w, C), zeros elsewhere
              (the unpool forward and the pool backward)
  gather2x2:  g (N, 2h, 2w, C), codes -> (N, h, w, C), g at each code
              (the unpool backward)

``MaxPoolArgmax2x2`` (forward pool, backward scatter; it saves only the
int8 codes) and ``MaxUnpool2x2`` (forward scatter, backward gather) are
the ``custom_vjp`` pair of the TPU module as ``torch.autograd.Function``s.
"""

from __future__ import annotations

import ctypes

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIG = (ctypes.c_int, [_P, _P, _P, _L, _L, _L, _I, _P])
LIBRARY = CudaLibrary("pooling", {
    # (a, b, c, rows = N*h, w, C, dtype, stream); see csrc/pooling.cu
    "spalign_pool2x2": _SIG,
    "spalign_scatter2x2": _SIG,
    "spalign_gather2x2": _SIG,
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pos(device) -> torch.Tensor:
    """(1, 1, 2, 1, 2, 1) int8 window-offset codes 2*dy + dx."""
    return torch.arange(4, dtype=torch.int8, device=device).reshape(
        1, 1, 2, 1, 2, 1)


def _check_values(x: torch.Tensor, name: str):
    if x.dim() != 4:
        raise ValueError(f"{name} must be NHWC (4-D), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")


def _check_codes(codes: torch.Tensor, shape, device):
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if tuple(codes.shape) != tuple(shape):
        raise ValueError(f"codes {tuple(codes.shape)} must have the pooled "
                         f"shape {tuple(shape)}")
    if codes.device != device:
        raise ValueError("codes must lie on the values' device")


def _launch(fn_name: str, a, b, out, n, h, w, c, dtype):
    """Launch one entry point of csrc/pooling.cu on the current stream."""
    for t in (a, b, out):
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: tensors must be contiguous NHWC")
    fn = getattr(LIBRARY.get(), fn_name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n * h, w, c,
                 _DTYPES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def pool2x2(x: torch.Tensor):
    """(N, 2h, 2w, C) -> (pooled (N, h, w, C), codes int8 (N, h, w, C))."""
    _check_values(x, "x")
    n, hh, ww, c = x.shape
    if hh % 2 or ww % 2:
        raise ValueError(f"pool2x2 needs even H and W, got {tuple(x.shape)}"
                         " (ops/pooling.py pads odd sizes)")
    if not _on_card(x):
        return pool2x2_reference(x)
    h, w = hh // 2, ww // 2
    pooled = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    codes = torch.empty((n, h, w, c), dtype=torch.int8, device=x.device)
    if pooled.numel():
        _launch("spalign_pool2x2", x, pooled, codes, n, h, w, c, x.dtype)
        pool2x2.launches += 1
    return pooled, codes


def scatter2x2(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(N, h, w, C) values to their codes' positions of (N, 2h, 2w, C)."""
    _check_values(x, "x")
    _check_codes(codes, x.shape, x.device)
    if not _on_card(x):
        return scatter2x2_reference(x, codes)
    n, h, w, c = x.shape
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("spalign_scatter2x2", x, codes, out, n, h, w, c, x.dtype)
        scatter2x2.launches += 1
    return out


def gather2x2(g: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(N, 2h, 2w, C) gradients -> (N, h, w, C): each element takes g at
    its code's position of its window."""
    _check_values(g, "g")
    n, hh, ww, c = g.shape
    if hh % 2 or ww % 2:
        raise ValueError(f"gather2x2 needs even H and W, got "
                         f"{tuple(g.shape)}")
    h, w = hh // 2, ww // 2
    _check_codes(codes, (n, h, w, c), g.device)
    if not _on_card(g):
        return gather2x2_reference(g, codes)
    out = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    if out.numel():
        _launch("spalign_gather2x2", g, codes, out, n, h, w, c, g.dtype)
        gather2x2.launches += 1
    return out


# kernel launches, for proof of the path taken
pool2x2.launches = 0
scatter2x2.launches = 0
gather2x2.launches = 0


def reset_launches():
    pool2x2.launches = scatter2x2.launches = gather2x2.launches = 0


# ---- plain versions: the XLA form of spalign_tpu/ops/pooling.py ----

def pool2x2_reference(x: torch.Tensor):
    """Plain PyTorch pool on the 6-D window view.  The pooled value is
    selected through the code (not reduced with max), so its gradient
    flows to the argmax element only, as Chainer's does."""
    n, hh, ww, c = x.shape
    xr = x.reshape(n, hh // 2, 2, ww // 2, 2, c)
    m = xr.detach().amax(dim=(2, 4), keepdim=True)
    # first max in window order: least code among the elements == max
    cand = torch.where(xr.detach() == m, _pos(x.device), 4)
    codes = cand.amin(dim=(2, 4))
    sel = cand == codes[:, :, None, :, None, :]
    pooled = torch.where(sel, xr, 0.0).sum(dim=(2, 4))
    return pooled, codes


def scatter2x2_reference(x: torch.Tensor, codes: torch.Tensor):
    n, h, w, c = x.shape
    sel = codes[:, :, None, :, None, :] == _pos(x.device)
    out = torch.where(sel, x[:, :, None, :, None, :], 0.0)
    return out.reshape(n, 2 * h, 2 * w, c)


def gather2x2_reference(g: torch.Tensor, codes: torch.Tensor):
    n, hh, ww, c = g.shape
    g6 = g.reshape(n, hh // 2, 2, ww // 2, 2, c)
    sel = codes[:, :, None, :, None, :] == _pos(g.device)
    return torch.where(sel, g6, 0.0).sum(dim=(2, 4))


# ---- differentiable wrappers (Chainer's route-to-argmax semantics) ----

class MaxPoolArgmax2x2(torch.autograd.Function):
    """x -> (pooled, codes); the backward scatters the pooled gradient
    to the argmax positions.  Saves only the int8 codes."""

    @staticmethod
    def forward(ctx, x):
        pooled, codes = pool2x2(x)
        ctx.save_for_backward(codes)
        ctx.mark_non_differentiable(codes)
        return pooled, codes

    @staticmethod
    def backward(ctx, g_pooled, g_codes):
        (codes,) = ctx.saved_tensors
        return scatter2x2(g_pooled.contiguous(), codes)


class MaxUnpool2x2(torch.autograd.Function):
    """(x, codes) -> the scatter of x; the backward gathers the upstream
    gradient at the codes.  The codes get no gradient."""

    @staticmethod
    def forward(ctx, x, codes):
        ctx.save_for_backward(codes)
        return scatter2x2(x, codes)

    @staticmethod
    def backward(ctx, g):
        (codes,) = ctx.saved_tensors
        return gather2x2(g.contiguous(), codes), None
