"""Diagnostic panels drawn with numpy and written as PNG (counterpart
of ``spalign_tpu/utils/viz.py``, which draws them with matplotlib).

The reference writes a 2x2 panel per labelled image
(batch_spalign_kmeans.py save_image, :361-387: estimated mask overlay,
GT mask, all clusters, road mask) and a 1x3 panel per relabelled image
(labels_from_segnet.py:97-119: overlay, GT, prediction).  Here each cell
is an NN resize (cv2 convention) of its array to the cell shape, which
keeps the image's aspect at most ``CELL_WIDTH`` pixels wide, coloured as
matplotlib's ``imshow`` colours it: a map is normalised by its own min
and max (all 0 when they are equal) and looked up in viridis (256
colours); the overlay blends the image with the mask in Set1_r (9
colours; a 0/1 mask takes its two end colours) at alpha 0.4.  Each cell
has its title above it, in a 5x7 bitmap font kept here, on a white
ground; a missing GT leaves its cell white, as the reference leaves the
axis empty.
"""

from __future__ import annotations

import os

import numpy as np

from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.ops.resize import nn_resize_np

CELL_WIDTH = 512  # the widest cell, in pixels
MARGIN = 8  # around and between the cells
FONT_SCALE = 2  # a glyph is 5x7 font pixels of FONT_SCALE^2 pixels
TITLE_BAND = 7 * FONT_SCALE + 6  # the title's band above a cell
OVERLAY_ALPHA = 0.4

# matplotlib's viridis, 256 RGB colours as uint8 (Colormap(bytes=True))
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f"
    "6247116347126547146647156747166947186a48196b481a6c481c6e481d6f48"
    "1e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f4535804536814437814439"
    "82433a83433b83433c84423d84423e854240854141864142864043874044873f"
    "45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c"
    "8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d31668d30"
    "678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b"
    "8e277c8e277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24"
    "868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e99"
    "8a1e9a891e9b891e9c891e9d881e9e881e9f881ea0871fa1871fa2861fa38620"
    "a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b7"
    "7836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be7045bf6f47"
    "c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d0"
    "5477d05279d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490"
    "d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e0"
    "1fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218dce218dfe318e1e318e4"
    "e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)
# Set1_r's two end colours (Colormap(bytes=True)): value 0 grey, 1 red
SET1_R_LOW = np.array([153, 153, 153], np.uint8)
SET1_R_HIGH = np.array([228, 26, 28], np.uint8)

# the titles' glyphs, 5 wide and 7 high
_GLYPHS = {
    "a": ".....|.....|.###.|....#|.####|#...#|.####",
    "c": ".....|.....|.###.|#....|#....|#...#|.###.",
    "d": "....#|....#|.##.#|#..##|#...#|#...#|.####",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.",
    "h": "#....|#....|#.##.|##..#|#...#|#...#|#...#",
    "i": "..#..|.....|.##..|..#..|..#..|..#..|.###.",
    "k": "#....|#....|#..#.|#.#..|##...|#.#..|#..#.",
    "l": ".##..|..#..|..#..|..#..|..#..|..#..|.###.",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#...#|#...#",
    "n": ".....|.....|#.##.|##..#|#...#|#...#|#...#",
    "o": ".....|.....|.###.|#...#|#...#|#...#|.###.",
    "r": ".....|.....|#.##.|##..#|#....|#....|#....",
    "s": ".....|.....|.###.|#....|.###.|....#|####.",
    "t": ".#...|.#...|###..|.#...|.#...|.#..#|..##.",
    "u": ".....|.....|#...#|#...#|#...#|#..##|.##.#",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|..#..",
    "y": ".....|.....|#...#|#...#|.####|....#|.###.",
    "A": ".###.|#...#|#...#|#####|#...#|#...#|#...#",
    "E": "#####|#....|#....|####.|#....|#....|#####",
    "G": ".###.|#...#|#....|#.###|#...#|#...#|.####",
    "(": "...#.|..#..|.#...|.#...|.#...|..#..|...#.",
    ")": ".#...|..#..|...#.|...#.|...#.|..#..|.#...",
    " ": ".....|.....|.....|.....|.....|.....|.....",
    # for the training curves' ticks and series keys (utils/curves.py)
    # and the titles of the examples' stage figures
    "b": "#....|#....|#.##.|##..#|#...#|#...#|####.",
    "f": "..##.|.#..#|.#...|###..|.#...|.#...|.#...",
    "g": ".....|.....|.####|#...#|.####|....#|.###.",
    "j": "...#.|.....|..##.|...#.|...#.|#..#.|.##..",
    "w": ".....|.....|#...#|#...#|#.#.#|#.#.#|.#.#.",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    "C": ".###.|#...#|#....|#....|#....|#...#|.###.",
    "I": ".###.|..#..|..#..|..#..|..#..|..#..|.###.",
    "L": "#....|#....|#....|#....|#....|#....|#####",
    "S": ".####|#....|#....|.###.|....#|....#|####.",
    "T": "#####|..#..|..#..|..#..|..#..|..#..|..#..",
    "=": ".....|.....|#####|.....|#####|.....|.....",
    "p": ".....|.....|####.|#...#|####.|#....|#....",
    "/": ".....|....#|...#.|..#..|.#...|#....|.....",
    "_": ".....|.....|.....|.....|.....|.....|#####",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    "-": ".....|.....|.....|.###.|.....|.....|.....",
    "+": ".....|..#..|..#..|#####|..#..|..#..|.....",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": "#####|...#.|..#..|...#.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": "..##.|.#...|#....|####.|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|.#...|.#...|.#...",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|...#.|.##..",
}

OVERLAY_TITLE = "Estimated road mask (overlay)"
GT_TITLE = "Ground truth road mask"
CLUSTERS_TITLE = "All clusters"
ROAD_TITLE = "Estimated road mask"


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS[ch].split("|")
    return np.array([[c == "#" for c in r] for r in rows], bool)


def text_mask(text: str, scale: int = FONT_SCALE) -> np.ndarray:
    """(7*scale, 6*scale*len(text)) bool: the text's pixels, a column of
    space after each glyph."""
    cols = []
    for ch in text:
        g = np.zeros((7, 6), bool)
        g[:, :5] = _glyph(ch)
        cols.append(g)
    m = np.concatenate(cols, 1) if cols else np.zeros((7, 0), bool)
    return m.repeat(scale, 0).repeat(scale, 1)


def _normalised(a: np.ndarray) -> np.ndarray:
    """``imshow``'s default normalisation: (a - min) / (max - min), all 0
    when the map is constant."""
    a = np.asarray(a, np.float64)
    lo, hi = a.min(), a.max()
    if hi == lo:
        return np.zeros(a.shape)
    return (a - lo) / (hi - lo)


def colormap_viridis(a: np.ndarray) -> np.ndarray:
    """(..., ) map -> (..., 3) uint8 viridis, normalised as ``imshow``."""
    idx = np.minimum((_normalised(a) * 256).astype(np.int64), 255)
    return VIRIDIS[idx]


def overlay(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 image under a (H, W) 0/1 mask in Set1_r's end
    colours at alpha 0.4 (the mask normalised as ``imshow``)."""
    high = _normalised(mask) >= 1.0
    color = np.where(high[..., None], SET1_R_HIGH, SET1_R_LOW)
    out = ((1.0 - OVERLAY_ALPHA) * img.astype(np.float32)
           + OVERLAY_ALPHA * color.astype(np.float32))
    return np.rint(out).astype(np.uint8)


def cell_shape(img_hw) -> tuple:
    """(h, w) of a panel cell for an image of ``img_hw``: the image's
    aspect, at most CELL_WIDTH wide."""
    h, w = int(img_hw[0]), int(img_hw[1])
    cw = min(w, CELL_WIDTH)
    return max(1, int(round(h * cw / w))), cw


def compose(cells, titles, n_cols: int, hw) -> np.ndarray:
    """The panel: ``cells`` ((h, w, 3) uint8 or None for a white cell) in
    rows of ``n_cols``, each under its title, on white."""
    ch, cw = hw
    n_rows = -(-len(cells) // n_cols)
    out = np.full((n_rows * (TITLE_BAND + ch) + (n_rows + 1) * MARGIN,
                   n_cols * cw + (n_cols + 1) * MARGIN, 3), 255, np.uint8)
    for i, (cell, title) in enumerate(zip(cells, titles)):
        if cell is None:
            continue
        y0, x0 = cell_origin(i, n_cols, hw)
        t = text_mask(title)[:, :cw]
        ty = y0 - TITLE_BAND + (TITLE_BAND - t.shape[0]) // 2
        tx = x0 + max(0, (cw - t.shape[1]) // 2)
        out[ty:ty + t.shape[0], tx:tx + t.shape[1]][t] = 0
        out[y0:y0 + ch, x0:x0 + cw] = cell
    return out


def cell_origin(i: int, n_cols: int, hw) -> tuple:
    """(y, x) of cell ``i``'s top-left pixel in a panel of ``compose``."""
    ch, cw = hw
    r, c = divmod(i, n_cols)
    return (MARGIN + r * (TITLE_BAND + ch + MARGIN) + TITLE_BAND,
            MARGIN + c * (cw + MARGIN))


def _write(out_dir, img_fn, panel):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, os.path.basename(img_fn))
    write_png(path, panel)
    return path


def diagnostic_panel(img, road_mask, cluster_map, label=None) -> np.ndarray:
    """The 2x2 panel (overlay / GT / clusters / road mask) as an RGB
    uint8 array.  Masks of another shape than the image are first
    NN-resized to it (cv2 convention), as the reference does."""
    img = np.asarray(img, np.uint8)
    road_mask, cluster_map = np.asarray(road_mask), np.asarray(cluster_map)
    if road_mask.shape != img.shape[:2]:
        road_mask = nn_resize_np(road_mask.astype(np.uint8), img.shape[:2])
        cluster_map = nn_resize_np(cluster_map.astype(np.uint8),
                                   img.shape[:2])
    hw = cell_shape(img.shape[:2])
    im, road = nn_resize_np(img.transpose(2, 0, 1), hw).transpose(1, 2, 0), \
        nn_resize_np(road_mask, hw)
    cells = [overlay(im, road),
             None if label is None else colormap_viridis(
                 nn_resize_np(np.asarray(label) == 1, hw)),
             colormap_viridis(nn_resize_np(cluster_map, hw)),
             colormap_viridis(road)]
    return compose(cells, [OVERLAY_TITLE, GT_TITLE, CLUSTERS_TITLE,
                           ROAD_TITLE], 2, hw)


def prediction_panel(img, pred, label=None) -> np.ndarray:
    """The 1x3 panel (overlay / GT / prediction) as an RGB uint8 array;
    each array is NN-resized to the cell shape from its own shape."""
    img = np.asarray(img, np.uint8)
    hw = cell_shape(img.shape[:2])
    im = nn_resize_np(img.transpose(2, 0, 1), hw).transpose(1, 2, 0)
    pred = nn_resize_np(np.asarray(pred), hw)
    cells = [overlay(im, pred),
             None if label is None else colormap_viridis(
                 nn_resize_np(np.asarray(label) == 1, hw)),
             colormap_viridis(pred)]
    return compose(cells, [OVERLAY_TITLE, GT_TITLE, ROAD_TITLE], 3, hw)


def save_diagnostic_panel(out_dir, img_fn, img, road_mask, cluster_map,
                          label=None) -> str:
    """Write the 2x2 panel as ``out_dir/basename(img_fn)`` (PNG bytes
    whatever the extension); returns the path."""
    return _write(out_dir, img_fn,
                  diagnostic_panel(img, road_mask, cluster_map, label))


def save_prediction_panel(out_dir, img_fn, img, pred, label=None) -> str:
    """Write the 1x3 panel as ``out_dir/basename(img_fn)``; returns the
    path."""
    return _write(out_dir, img_fn, prediction_panel(img, pred, label))
