"""The port's SegNet pooling (spalign_tpu_torch/ops/pooling.py and
kernels/pooling.py) against the JAX package's.

On the CPU the port runs its plain versions: through the ops layer (the
plain autograd path) and through the kernels' autograd functions (whose
wrappers take the plain versions for CPU tensors).  The JAX side is the
XLA form of spalign_tpu/ops/pooling.py and the Pallas kernels in
interpret mode, as tests/test_pooling_pallas.py runs them.  Tolerance:
none — values, codes and gradients are bit-equal (each output element is
one input element selected by a compare, or zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.kernels import pooling_pallas as pp
from spalign_tpu.ops import pooling as jpool
from spalign_tpu_torch.kernels import pooling as tk
from spalign_tpu_torch.ops import pooling as tpool

# (N, H, W, C), dtype, zero band: the cases of tests/test_pooling_pallas.py
CASES = {
    "ties": ((2, 8, 12, 64), "float32", True),
    "bf16_c128": ((1, 6, 12, 128), "bfloat16", False),
    "ragged_rows": ((3, 10, 8, 64), "float32", False),
    "wide_rows": ((2, 16, 24, 64), "float32", True),
}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _draw(seed, shape, band=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if band:
        # exact ties are the norm after relu: zero a band to create them
        x[np.abs(x) < 0.4] = 0.0
    return x


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds
    from the same float32 in both)."""
    return (jnp.asarray(x).astype(JAX_DT[dtype]),
            torch.from_numpy(x).to(TORCH_DT[dtype]))


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.detach().float() if a.is_floating_point()
                else a.detach()).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _port_pools(xt):
    """(pooled, codes) of both port paths on a CPU tensor."""
    return [tpool.max_pool_argmax_2x2(xt), tk.MaxPoolArgmax2x2.apply(xt)]


@pytest.mark.parametrize("case", CASES)
def test_pool_matches_jax(case):
    shape, dtype, band = CASES[case]
    xj, xt = _pair(_draw(1, shape, band), dtype)
    p_ref, i_ref = jpool.max_pool_argmax_2x2(xj)
    p_pal, i_pal = pp.pool2x2_pallas(xj, interpret=True)
    np.testing.assert_array_equal(_np(p_ref), _np(p_pal))
    for pooled, codes in _port_pools(xt):
        assert codes.dtype == torch.int8
        assert pooled.dtype == xt.dtype
        np.testing.assert_array_equal(_np(pooled), _np(p_ref))
        np.testing.assert_array_equal(_np(codes),
                                      _np(i_ref).astype(np.int8))
        np.testing.assert_array_equal(_np(codes), _np(i_pal))


@pytest.mark.parametrize("case", CASES)
def test_unpool_matches_jax(case):
    (n, h, w, c), dtype, band = CASES[case]
    xj, xt = _pair(_draw(2, (n, h, w, c), band), dtype)
    _, idx_j = pp.pool2x2_pallas(xj, interpret=True)
    _, idx_t = tk.pool2x2(xt)
    yj, yt = _pair(_draw(3, (n, h // 2, w // 2, c)), dtype)
    u_ref = jpool.max_unpool_2x2(yj, idx_j)
    u_pal = pp.scatter2x2_pallas(yj, idx_j, interpret=True)
    np.testing.assert_array_equal(_np(u_ref), _np(u_pal))
    for got in (tpool.max_unpool_2x2(yt, idx_t),
                tk.MaxUnpool2x2.apply(yt, idx_t), tk.scatter2x2(yt, idx_t)):
        assert got.dtype == yt.dtype
        np.testing.assert_array_equal(_np(got), _np(u_ref))


@pytest.mark.parametrize("case", CASES)
def test_pool_backward_routes_to_argmax_only(case):
    """The pool's gradient equals jax.grad of the XLA form and the
    Pallas scatter of the weights: each window's gradient lands on its
    first maximum only."""
    (n, h, w, c), dtype, band = CASES[case]
    x = _draw(4, (n, h, w, c), band)
    xj, _ = _pair(x, dtype)
    wj, wt = _pair(_draw(5, (n, h // 2, w // 2, c)), dtype)
    g_ref = jax.grad(
        lambda v: jnp.sum(jpool.max_pool_argmax_2x2(v)[0] * wj))(xj)
    _, idx = pp.pool2x2_pallas(xj, interpret=True)
    g_pal = pp.scatter2x2_pallas(wj, idx, interpret=True)
    np.testing.assert_array_equal(_np(g_ref), _np(g_pal))
    for pool in (tpool.max_pool_argmax_2x2, tk.MaxPoolArgmax2x2.apply):
        xt = torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_(True)
        (pool(xt)[0] * wt).sum().backward()
        np.testing.assert_array_equal(_np(xt.grad), _np(g_ref))


@pytest.mark.parametrize("case", CASES)
def test_unpool_backward_gathers_at_codes(case):
    (n, h, w, c), dtype, band = CASES[case]
    xj, xt = _pair(_draw(6, (n, h, w, c), band), dtype)
    _, idx_j = pp.pool2x2_pallas(xj, interpret=True)
    _, idx_t = tk.pool2x2(xt)
    y = _draw(7, (n, h // 2, w // 2, c))
    yj, _ = _pair(y, dtype)
    gj, gt = _pair(_draw(8, (n, h, w, c)), dtype)
    g_ref = jax.vjp(lambda v: jpool.max_unpool_2x2(v, idx_j), yj)[1](gj)[0]
    g_pal = pp.gather2x2_pallas(gj, idx_j, interpret=True)
    np.testing.assert_array_equal(_np(g_ref), _np(g_pal))
    np.testing.assert_array_equal(_np(tk.gather2x2(gt, idx_t)), _np(g_ref))
    for unpool in (tpool.max_unpool_2x2, tk.MaxUnpool2x2.apply):
        yt = torch.from_numpy(y).to(TORCH_DT[dtype]).requires_grad_(True)
        unpool(yt, idx_t).backward(gt)
        np.testing.assert_array_equal(_np(yt.grad), _np(g_ref))


@pytest.mark.parametrize("shape", [(2, 7, 9, 64), (1, 5, 8, 3),
                                   (2, 6, 11, 16)])
def test_odd_sizes_pad_with_minus_inf(shape):
    """Odd H or W: Chainer's cover_all output size, the -inf pad never
    wins; values, codes and the gradient match JAX."""
    x = _draw(9, shape, band=True)
    p_ref, i_ref = jpool.max_pool_argmax_2x2(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pooled, codes = tpool.max_pool_argmax_2x2(xt)
    assert pooled.shape == (shape[0], -(-shape[1] // 2), -(-shape[2] // 2),
                            shape[3])
    np.testing.assert_array_equal(_np(pooled), _np(p_ref))
    np.testing.assert_array_equal(_np(codes), _np(i_ref))
    assert np.isfinite(_np(pooled)).all()
    wgt = _draw(10, pooled.shape)
    g_ref = jax.grad(lambda v: jnp.sum(
        jpool.max_pool_argmax_2x2(v)[0] * wgt))(jnp.asarray(x))
    (pooled * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), _np(g_ref))


@pytest.mark.parametrize("out_hw", [None, (7, 9), (6, 10)])
def test_unpool_crops_mismatched_shapes(out_hw):
    """Decoder/encoder mismatch on odd sizes: both crop to the common
    shape, then the output crops to out_hw (reference
    models/segnet_basic.py:49-53)."""
    x = _draw(11, (2, 8, 10, 64), band=True)
    _, idx = jpool.max_pool_argmax_2x2(jnp.asarray(x))  # (2, 4, 5, 64)
    y = _draw(12, (2, 5, 6, 64))  # one row and column too many
    want = jpool.max_unpool_2x2(jnp.asarray(y), idx, out_hw=out_hw)
    yt = torch.from_numpy(y).requires_grad_(True)
    got = tpool.max_unpool_2x2(yt, torch.from_numpy(np.array(idx)),
                               out_hw=out_hw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    g = _draw(13, tuple(want.shape))
    g_ref = jax.vjp(lambda v: jpool.max_unpool_2x2(v, idx, out_hw=out_hw),
                    jnp.asarray(y))[1](jnp.asarray(g))[0]
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt.grad), _np(g_ref))


def test_all_minus_inf_window_gives_code_zero():
    x = np.full((1, 2, 4, 3), -np.inf, np.float32)
    x[0, 1, 3, 0] = 1.0
    pooled, codes = tk.pool2x2(torch.from_numpy(x))
    p_ref, i_ref = jpool.max_pool_argmax_2x2(jnp.asarray(x))
    np.testing.assert_array_equal(_np(pooled), _np(p_ref))
    np.testing.assert_array_equal(_np(codes), _np(i_ref))
    assert codes[0, 0, 0, 0] == 0 and codes[0, 0, 1, 0] == 3


@pytest.mark.parametrize("call,err", [
    (lambda: tk.pool2x2(torch.zeros(1, 3, 4, 8)), ValueError),  # odd H
    (lambda: tk.pool2x2(torch.zeros(3, 4, 8)), ValueError),  # not 4-D
    (lambda: tk.pool2x2(torch.zeros(1, 2, 4, 8, dtype=torch.float64)),
     TypeError),
    (lambda: tk.scatter2x2(torch.zeros(1, 2, 2, 8),
                           torch.zeros(1, 2, 2, 8, dtype=torch.int32)),
     TypeError),
    (lambda: tk.scatter2x2(torch.zeros(1, 2, 2, 8),
                           torch.zeros(1, 2, 3, 8, dtype=torch.int8)),
     ValueError),
    (lambda: tk.gather2x2(torch.zeros(1, 4, 4, 8),
                          torch.zeros(1, 2, 3, 8, dtype=torch.int8)),
     ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def test_cpu_tensors_count_no_launch():
    before = (tk.pool2x2.launches, tk.scatter2x2.launches,
              tk.gather2x2.launches)
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    p, c = tk.MaxPoolArgmax2x2.apply(x)
    tk.MaxUnpool2x2.apply(p, c).sum().backward()
    assert (tk.pool2x2.launches, tk.scatter2x2.launches,
            tk.gather2x2.launches) == before
