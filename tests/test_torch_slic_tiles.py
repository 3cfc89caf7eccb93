"""The per-tile candidate filter of the two SLIC kernels and the split
centre update, on the CPU.

Both kernels (``csrc/slic_lloyd.cu``, ``csrc/slic_assign.cu``) score a
pixel only against the candidates of its warp's strip of pixels (4 rows
of a block's 32 x 32 tile, ``slic_assign.STRIP``).
``tile_candidates`` is that filter in plain PyTorch.  It must be a superset
of every pixel's window set, whatever the centres: on the grid, drifted by
several cells, partly outside the image, or all far away (every window
empty).  Then the labels computed from the candidate lists equal
``slic_assign_reference`` exactly, and so the kernels' labels can equal it
bit for bit.  The assignment kernel first stages the survivors of the
same filter over its whole 32 x 32 tile (``slic_assign.TILE``, at most
``STAGE_CAP`` of them): they must hold every strip's candidates, and on
the grid at the label paths' shapes they fit the stage.  Tolerance: none
(boolean sets and integer labels).

The centre update is split into ``center_sums`` (the plain version of the
assignment kernel's fused int64 sums) and ``centers_from_sums``; their
composition is ``update_centers``, and the sums are the exact integer
sums of an int64 ``index_add_``."""

import numpy as np
import pytest
import torch

from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.kernels import slic_assign as tsa

torch.set_num_threads(2)

# the kernels' strip, and the block's tile it is cut from
STRIPS = [tsa.STRIP, (8 * tsa.STRIP[0], tsa.STRIP[1])]
# (H, W, n_segments) with K = 9, 100 and 990 grid centres; H*W ragged
# against every strip shape
IMAGES = {9: (45, 45, 9), 100: (150, 150, 100), 990: (99, 110, 1000)}
# and K = 4,096 at a grid step of 2 px, for the assignment kernel's staging
STAGE_IMAGES = {**IMAGES, 4096: (128, 128, 4096)}


def _case(k, case, seed=0):
    """lab (1, 3, HW), centres (1, K, 5) and the shape keywords."""
    h, w, n_seg = STAGE_IMAGES[k]
    assert tslic.slic_grid_size(h, w, n_seg) == k
    rng = np.random.RandomState(seed + k)
    img = torch.from_numpy(rng.randint(0, 255, (1, h, w, 3)).astype(
        np.float32))
    lab, c0, shape = tslic.slic_inputs(img, n_seg, 10.0)
    step = shape["window"] / 2
    c = c0.clone()
    if case == "drifted":  # up to 3 cells in each axis
        c[..., 3:] += torch.from_numpy(
            rng.uniform(-3, 3, (1, k, 2)).astype(np.float32)) * step
    elif case == "outside":  # a third of them off the image
        off = torch.from_numpy(rng.rand(k) < 1 / 3)
        c[0, off, 3] = -c[0, off, 3] - 2 * step
        c[0, off, 4] += w
    elif case == "far":  # every window empty
        c[..., 3] += 10 * h
    return lab, c, shape


def _in_window(centers, shape):
    """(HW, K) bool: the exact window test of slic_assign_reference."""
    h, w = shape["height"], shape["width"]
    win = torch.tensor(shape["window"], dtype=torch.float32)
    pix = torch.arange(h * w)
    fy = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    fx = (pix % w).to(torch.float32)
    cy, cx = centers[0, :, 3], centers[0, :, 4]
    return (((fy[:, None] - cy).abs() <= win)
            & ((fx[:, None] - cx).abs() <= win))


def _strip_of_pixel(shape, strip):
    """(HW,) index of each pixel's strip in tile_candidates' row-major
    order."""
    h, w = shape["height"], shape["width"]
    pix = torch.arange(h * w)
    sy = torch.div(pix, w, rounding_mode="floor") // strip[0]
    sx = (pix % w) // strip[1]
    return sy * (-(-w // strip[1])) + sx


def _labels_from_candidates(lab, centers, shape, cand, strip):
    """slic_assign_reference's rule, each pixel scored against its strip's
    candidates only: argmax over the candidates in the window (lowest id
    on ties), the unmasked argmax when none is."""
    h, w = shape["height"], shape["width"]
    f32 = torch.float32
    ratio = torch.tensor(shape["ratio"], dtype=f32)
    pix = torch.arange(h * w)
    py = torch.div(pix, w, rounding_mode="floor")
    pyr, pxr = py.to(f32) * ratio, (pix - py * w).to(f32) * ratio
    c = centers[0]
    cl, ca, cb = c[:, 0], c[:, 1], c[:, 2]
    cyr, cxr = c[:, 3] * ratio, c[:, 4] * ratio
    half = 0.5 * (cl * cl + ca * ca + cb * cb + cyr * cyr + cxr * cxr)
    pl, pa, pb = (lab[0, i, :, None] for i in range(3))
    score = (cl * pl + ca * pa + cb * pb + cyr * pyr[:, None]
             + cxr * pxr[:, None] - half)
    ok = _in_window(centers, shape) & cand[0][_strip_of_pixel(shape, strip)]
    masked = torch.where(ok, score, float("-inf"))
    return torch.where(ok.any(-1), masked.argmax(-1),
                       score.argmax(-1)).to(torch.int32)


@pytest.mark.parametrize("case", ["grid", "drifted", "outside", "far"])
@pytest.mark.parametrize("k", sorted(IMAGES))
def test_candidates_cover_every_window(k, case):
    lab, c, shape = _case(k, case)
    in_win = _in_window(c, shape)
    if case == "far":
        assert not in_win.any()
    want = tsa.slic_assign_reference(lab, c, **shape)
    for strip in STRIPS:
        cand = tsa.tile_candidates(c, shape["height"], shape["width"], strip,
                                   shape["window"])
        n_strips = (-(-shape["height"] // strip[0])
                    * -(-shape["width"] // strip[1]))
        assert cand.shape == (1, n_strips, k) and cand.dtype == torch.bool
        missed = in_win & ~cand[0][_strip_of_pixel(shape, strip)]
        assert not missed.any(), (strip, int(missed.sum()))
        if case == "grid" and k >= 100:  # the filter does filter
            assert cand.float().sum(-1).max() < k / 2
        got = _labels_from_candidates(lab, c, shape, cand, strip)
        np.testing.assert_array_equal(got.numpy(), want[0].numpy())


@pytest.mark.parametrize("case", ["grid", "drifted", "outside", "far"])
@pytest.mark.parametrize("k", sorted(STAGE_IMAGES))
def test_tile_survivors_hold_every_strip_candidate(k, case):
    """The assignment kernel stages the survivors of its 32 x 32 tile's
    filter, and each warp filters its strip among them: every strip's
    candidates among all K are survivors of its tile, so the strip scans
    the same centres in the same (id) order as over all K."""
    _, c, shape = _case(k, case)
    h, w, win = shape["height"], shape["width"], shape["window"]
    tiles = tsa.tile_candidates(c, h, w, tsa.TILE, win)[0]
    strips = tsa.tile_candidates(c, h, w, tsa.STRIP, win)[0]
    n_x = -(-w // tsa.TILE[1])
    assert tsa.STRIP[1] == tsa.TILE[1]
    sy = torch.arange(-(-h // tsa.STRIP[0]))
    tile_of = ((sy // (tsa.TILE[0] // tsa.STRIP[0]))[:, None] * n_x
               + torch.arange(n_x)).reshape(-1)
    assert strips.shape[0] == len(tile_of)
    assert not (strips & ~tiles[tile_of]).any()
    if case == "grid" and k >= 990:  # the tile filter does filter
        assert tiles.float().sum(-1).max() < k / 2


@pytest.mark.parametrize("h,w,n_seg", [(224, 224, 100), (1024, 2048, 100),
                                       (512, 1024, 1024), (1024, 2048, 4096),
                                       (128, 128, 4096)])
def test_grid_survivors_fit_the_stage(h, w, n_seg):
    """On the grid, at the shapes the label paths and chip_smoke run (the
    overlaps frames at K = 98, bench.py's overlaps_slic at K = 1,035, K =
    4,095 on 1024x2048, and the 2 px step of K = 4,096 at 128x128), no
    tile has more survivors than the assignment kernel stages: its staged
    path runs, not the scan of every centre."""
    centers_yx, step = tslic._init_centers(h, w, n_seg)[:2]
    c = torch.zeros((1, len(centers_yx), 5))
    c[0, :, 3:] = torch.from_numpy(centers_yx)
    most = int(tsa.tile_candidates(c, h, w, tsa.TILE, 2.0 * step).sum(
        -1).max())
    assert 0 < most <= tsa.STAGE_CAP


def test_candidates_follow_the_kernel_bounds():
    """A centre exactly window + 1 outside a strip's last row is a
    candidate, one a float32 step further is not (the kernels' float32
    bounds)."""
    window = 10.0
    pad = np.float32(window) + np.float32(1.0)
    edge = np.float32(3.0) + pad  # strip rows 0..3
    c = torch.zeros((1, 2, 5))
    c[0, 0, 3] = float(edge)
    c[0, 1, 3] = float(np.nextafter(edge, np.float32(np.inf)))
    cand = tsa.tile_candidates(c, 8, 32, (4, 32), window)
    assert cand[0, 0].tolist() == [True, False]


@pytest.mark.parametrize("b,hw,k,empty", [(2, 30 * 40, 7, (1, 3)),
                                          (3, 17 * 23, 40, (0, 39)),
                                          (1, 64, 1, None)])
def test_center_sums_are_exact_integer_sums(b, hw, k, empty):
    """center_sums (bincount over float64) equals an int64 index_add_ of
    the same addends, and centers_from_sums of it equals update_centers,
    an empty centre keeping its place."""
    rng = np.random.RandomState(b * hw + k)
    lab = torch.from_numpy(rng.rand(b, 3, hw).astype(np.float32) * 200 - 100)
    labels = torch.from_numpy(rng.randint(0, k, (b, hw)).astype(np.int32))
    if empty is not None:
        img, idx = empty
        labels[img][labels[img] == idx] = (idx + 1) % k
    centers = torch.from_numpy(rng.rand(b, k, 5).astype(np.float32))
    rows = tsa.pixel_rows(lab, hw // 2 if hw % 2 == 0 else hw)
    ids = (labels.long() + torch.arange(b)[:, None] * k).reshape(-1)
    want = torch.zeros((6, b * k), dtype=torch.int64).index_add_(
        1, ids, rows.to(torch.int64)).T.reshape(b, k, 6)
    sums = tsa.center_sums(rows, labels, centers)
    assert sums.dtype == torch.int64 and sums.shape == (b, k, 6)
    assert torch.equal(sums, want)
    new = tsa.centers_from_sums(sums, centers)
    assert torch.equal(new, tsa.update_centers(rows, labels, centers))
    if empty is not None:
        assert torch.equal(new[empty], centers[empty])


def test_cpu_wrapper_sums_are_the_plain_version(rng):
    """slic_assign(sums=True) on CPU tensors is center_sums over the plain
    labels, and launches nothing."""
    lab = torch.from_numpy(rng.rand(2, 3, 20 * 28).astype(np.float32) * 50)
    c = torch.from_numpy(rng.rand(2, 9, 5).astype(np.float32) * 20)
    kw = dict(height=20, width=28, ratio=1.0, window=8.0)
    before = tsa.slic_assign.launches
    sums = tsa.slic_assign(lab, c, sums=True, **kw)
    assert tsa.slic_assign.launches == before
    want = tsa.center_sums(tsa.pixel_rows(lab, 28),
                           tsa.slic_assign_reference(lab, c, **kw), c)
    assert torch.equal(sums, want)
    assert int(sums[..., 5].sum()) == 2 * 20 * 28
