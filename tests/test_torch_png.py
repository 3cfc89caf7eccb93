"""The port's PNG codec (spalign_tpu_torch/data/png.py) and cubic resize
(native.resize_cubic_u8) against cv2, on the CPU.

Tolerances: PNG decode and encode exact (every supported form, every
filter type); the host library's un-filter and resize exact against
their plain numpy versions.  The resize against cv2's default
INTER_CUBIC (IPP on): within 1 on at most 2e-4 of the values — the port
uses a float32 separable form that misses cv2's arithmetic by one ulp
before rounding on a few values a frame (test_resize_close_to_cv2
states the counts)."""

import importlib
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from spalign_tpu_torch import native
from spalign_tpu_torch.data import png

RESIZE_SHAPES = [((64, 128), (32, 64)), ((128, 256), (112, 112)),
                 ((512, 1024), (224, 224)), ((96, 128), (56, 56)),
                 ((1024, 2048), (224, 224))]


def _image(shape, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    # smooth rows and grey pixels: filters and the grey shortcut both act
    img[: shape[0] // 3] = np.cumsum(img[: shape[0] // 3] // 16, axis=1)
    if img.ndim == 3 and img.shape[-1] >= 3:
        img[-3:, :, 1:3] = img[-3:, :, :1]
    return img


def _cv2_decode(data, color):
    out = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    return out[:, :, ::-1] if color else out


def _filter_rows(px, bpp, types):
    """PNG-filter the rows of (H, row_bytes) uint8 with filter types
    ``types`` (one per row): the encoder side of the un-filter."""
    px = px.astype(np.int32)
    h, rb = px.shape
    out = np.zeros((h, rb + 1), np.uint8)
    for y in range(h):
        ft = types[y]
        prev = px[y - 1] if y else np.zeros(rb, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), px[y, :-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out[y, 0] = ft
        out[y, 1:] = (px[y] - pred) & 255
    return out


def _png_bytes(w, h, depth, ctype, idat, interlace=0, extra=()):
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                    interlace)), *extra,
              (b"IDAT", idat), (b"IEND", b"")]
    return png.SIGNATURE + b"".join(png._chunk(k, v) for k, v in chunks)


@pytest.mark.parametrize("form", ["grey", "rgb", "rgba", "grey_alpha"])
@pytest.mark.parametrize("color", [True, False], ids=["color", "grey"])
def test_decode_equals_cv2_on_cv2_files(form, color):
    img = _image({"grey": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4),
                  "grey_alpha": (37, 53, 2)}[form])
    if form == "grey_alpha":
        buf = io.BytesIO()
        Image.fromarray(img, "LA").save(buf, "PNG")
        data = buf.getvalue()
    else:
        ok, enc = cv2.imencode(".png", img)
        assert ok
        data = enc.tobytes()
    got = png.decode_png(data, color=color)
    want = _cv2_decode(data, color)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color", [True, False], ids=["color", "grey"])
def test_decode_palette_png_written_by_pil(color):
    rgb = _image((40, 56, 3), seed=1)
    pal = Image.fromarray(rgb).quantize(256)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    data = buf.getvalue()
    assert struct.unpack(">IIBB", data[16:26])[2:] == (8, 3)
    np.testing.assert_array_equal(png.decode_png(data, color=color),
                                  _cv2_decode(data, color))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels,ctype", [(1, 0), (3, 2), (4, 6)])
def test_every_filter_type(ftype, channels, ctype):
    img = _image((23, 31, channels), seed=channels)
    h, w = img.shape[:2]
    types = ([ftype] * h if ftype != "mixed"
             else [y % 5 for y in range(h)])
    raw = _filter_rows(img.reshape(h, -1), channels, types)
    data = _png_bytes(w, h, 8, ctype, zlib.compress(raw.tobytes()))
    np.testing.assert_array_equal(
        native.png_unfilter(raw.tobytes(), h, w * channels, channels),
        img.reshape(h, -1))
    np.testing.assert_array_equal(
        native.png_unfilter_reference(raw.tobytes(), h, w * channels,
                                      channels), img.reshape(h, -1))
    for color in (True, False):
        np.testing.assert_array_equal(png.decode_png(data, color=color),
                                      _cv2_decode(data, color))


def test_unknown_filter_type_raises():
    raw = _filter_rows(_image((4, 6)), 1, [0, 1, 2, 3])
    raw[2, 0] = 5
    with pytest.raises(ValueError, match="row 2"):
        native.png_unfilter(raw.tobytes(), 4, 6, 1)


@pytest.mark.parametrize("form,match", [
    ("interlaced", "interlaced"), ("16-bit", "16-bit"),
    ("1-bit", "1-bit"), ("not_png", "not a PNG"), ("corrupt", "corrupt")])
def test_unsupported_forms_raise(form, match):
    if form == "interlaced":
        data = _png_bytes(4, 4, 8, 2, zlib.compress(bytes(4 * 13)),
                          interlace=1)
    elif form == "16-bit":
        ok, enc = cv2.imencode(".png", (_image((8, 8, 3)).astype(np.uint16)
                                        * 257))
        data = enc.tobytes()
    elif form == "1-bit":
        buf = io.BytesIO()
        Image.fromarray(_image((8, 8)) > 127).save(buf, "PNG")
        data = buf.getvalue()
    elif form == "not_png":
        data = cv2.imencode(".jpg", _image((8, 8, 3)))[1].tobytes()
    else:
        data = bytearray(png.encode_png(_image((8, 8, 3))))
        data[40] ^= 0xFF
        data = bytes(data)
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


@pytest.mark.parametrize("shape", [(33, 47), (33, 47, 3), (1, 1),
                                   (1024, 2048, 3)])
def test_encode_round_trips_through_cv2(shape, tmp_path):
    img = _image(shape, seed=2)
    color = img.ndim == 3
    data = png.encode_png(img)
    np.testing.assert_array_equal(_cv2_decode(data, color), img)
    np.testing.assert_array_equal(png.decode_png(data, color), img)
    path = tmp_path / "x.png"
    png.write_png(str(path), img)
    assert path.read_bytes() == data


def test_encode_rejects_other_forms():
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.int32)):
        with pytest.raises(ValueError):
            png.encode_png(bad)


@pytest.mark.parametrize("src,dst", RESIZE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_resize_close_to_cv2(src, dst):
    """Measured mismatches against cv2 5.0.0's default INTER_CUBIC on
    these random frames (seed 0), in the order of RESIZE_SHAPES: 0 of
    6,144, 0 of 37,632, 3 of 150,528, 1 of 9,408 and 1 of 150,528."""
    img = np.random.RandomState(0).randint(0, 256, src + (3,)).astype(
        np.uint8)
    got = native.resize_cubic_u8(img, dst)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 2e-4 * got.size


@pytest.mark.parametrize("src,dst", [((30, 40), (24, 32)),
                                     ((30, 40), (70, 90)),
                                     ((96, 128), (56, 56)),
                                     ((16, 16), (16, 16))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_plain_version(src, dst, channels):
    shape = src + (channels,)
    img = np.random.RandomState(channels).randint(0, 256, shape).astype(
        np.uint8)
    got = native.resize_cubic_u8(img, dst)
    np.testing.assert_array_equal(
        got, native.resize_cubic_u8_reference(img, dst))
    assert got.shape == dst + (channels,)
    batch = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(
        native.resize_cubic_u8(batch, dst)[1],
        native.resize_cubic_u8_reference(img[::-1], dst))


def test_resize_rejects_other_forms():
    for bad in (np.zeros((8, 8), np.uint8), np.zeros((8, 8, 3), np.int32)):
        with pytest.raises(ValueError):
            native.resize_cubic_u8(bad, (4, 4))


def test_resize_golden_hash():
    """The constant chip_smoke.py holds the card host's resize to."""
    smoke = importlib.import_module("chip_smoke")
    frames = smoke.golden_frames()
    assert smoke.sha256(frames) == smoke.GOLDEN_FRAMES_SHA256
    got = native.resize_cubic_u8(frames, (224, 224))
    assert smoke.sha256(got) == smoke.GOLDEN_RESIZE_SHA256
    want = np.stack([native.resize_cubic_u8_reference(f, (224, 224))
                     for f in frames])
    np.testing.assert_array_equal(got, want)
