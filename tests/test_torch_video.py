"""The port's MJPG demo video (spalign_tpu_torch/utils/video.py) and its
JPEG encoder (native.encode_jpeg_rgb, csrc/host_ops.cpp) against their
plain versions, cv2 and the JAX package's spalign_tpu/utils/video.py,
on the CPU.

Tolerances: the encoder and its numpy reference byte-equal, and both
byte-equal to cv2.imencode's JPEG (libjpeg-turbo) at the same quality;
cv2's decode of a frame within PSNR 38 dB of the input, and the AVI's
frames within 35 dB of blend_road's output (smooth test images: 4:2:0
chroma cannot hold per-pixel colour noise at any quality); blend_road
and the resizes exact."""

import os

import cv2
import numpy as np
import pytest

from spalign_tpu.utils import video as jvideo
from spalign_tpu_torch import native
from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.utils import video


def _smooth(h, w, seed):
    """Low-frequency colour fields: what a 4:2:0 JPEG holds well."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, 3))
    for c in range(3):
        fy, fx, ph = rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0), \
            rng.uniform(0, 6.3)
        out[..., c] = 128 + 90 * np.sin(2 * np.pi * (fy * y + fx * x) / 256
                                        + ph)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


SIZES = [(1, 1), (17, 33), (8, 8), (9, 7), (31, 45), (2, 300), (64, 128)]


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_equals_reference_and_libjpeg(hw):
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    for img in (rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
                _smooth(*hw, seed=hw[1])):
        got = native.encode_jpeg_rgb(img, video.MJPG_QUALITY)
        assert got == native.encode_jpeg_rgb_reference(img,
                                                       video.MJPG_QUALITY)
        ok, want = cv2.imencode(".jpg", img[..., ::-1],
                                [cv2.IMWRITE_JPEG_QUALITY,
                                 video.MJPG_QUALITY])
        assert ok and got == want.tobytes()
    dec = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
    assert dec.shape == (*hw, 3)
    assert _psnr(dec[..., ::-1], img) >= 38.0


@pytest.mark.parametrize("quality", [1, 30, 75, 100])
def test_encoder_quality_scaling(quality):
    img = np.random.RandomState(quality).randint(0, 256, (24, 40, 3)).astype(
        np.uint8)
    got = native.encode_jpeg_rgb(img, quality)
    assert got == native.encode_jpeg_rgb_reference(img, quality)
    ok, want = cv2.imencode(".jpg", img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert got == want.tobytes()


def test_encoder_batch_equals_single_and_rejects_bad_input():
    imgs = np.stack([_smooth(40, 56, s) for s in range(5)])
    assert native.encode_jpeg_rgb(imgs, 90) == [
        native.encode_jpeg_rgb(i, 90) for i in imgs]
    with pytest.raises(ValueError, match="uint8"):
        native.encode_jpeg_rgb(imgs.astype(np.float32), 90)
    with pytest.raises(ValueError, match="quality"):
        native.encode_jpeg_rgb(imgs[0], 0)


def test_blend_road_equals_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (33, 47, 3)).astype(np.uint8)
    mask = rng.randint(0, 2, (33, 47)).astype(np.uint8)
    for alpha in (0.5, 0.3):
        np.testing.assert_array_equal(video.blend_road(img, mask, alpha),
                                      jvideo.blend_road(img, mask, alpha))


@pytest.mark.parametrize("src,dst", [((48, 64), (96, 128)),
                                     ((128, 256), (77, 151)),
                                     ((37, 53), (64, 80)),
                                     ((5, 5), (13, 11)),
                                     ((1, 7), (3, 9))])
def test_linear_resize_equals_cv2(src, dst):
    img = np.random.RandomState(src[0]).randint(0, 256, (*src, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(video.resize_linear_u8(img, dst),
                                  cv2.resize(img, (dst[1], dst[0])))


def _frames(n, hw):
    out = []
    for i in range(n):
        img = _smooth(*hw, seed=i)
        mask = np.zeros(hw, np.uint8)
        mask[hw[0] // 2 + 2 * i:] = 1
        out.append((img, mask))
    return out


@pytest.mark.parametrize("size_wh", [None, (80, 48)])
def test_overlay_video_opens_in_cv2(tmp_path, size_wh):
    frames = _frames(11, (64, 96))  # more than FRAMES_PER_ENCODE
    path = str(tmp_path / "demo.avi")
    assert video.write_overlay_video(iter(frames), path, fps=25,
                                     size_wh=size_wh) == 11
    cap = cv2.VideoCapture(path)
    try:
        assert cap.isOpened()
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 11
        assert cap.get(cv2.CAP_PROP_FPS) == 25
        for img, mask in frames:
            ok, got = cap.read()
            assert ok
            want = video.blend_road(img, mask)
            if size_wh is not None:
                want = cv2.resize(want, size_wh)
            assert got.shape == want.shape
            assert _psnr(got[..., ::-1], want) >= 35.0
        assert not cap.read()[0]
    finally:
        cap.release()
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert int.from_bytes(data[4:8], "little") == len(data) - 8
    assert b"idx1" in data and data.count(b"00dc") == 2 * 11


def test_size_guard_leaves_no_file(tmp_path, monkeypatch):
    path = str(tmp_path / "big.avi")
    monkeypatch.setattr(video, "AVI_MAX_BYTES", 4096)
    with pytest.raises(ValueError, match="4096 bytes"):
        video.write_overlay_video(iter(_frames(11, (64, 96))), path)
    assert not os.path.exists(path)


def test_frames_from_dirs_equals_jax(tmp_path):
    frames = _frames(3, (40, 64))
    for i, (img, mask) in enumerate(frames):
        write_png(str(tmp_path / f"f{i}.png"), img)
        if i != 1:  # a frame without a mask is skipped
            small = mask[::3, ::2] if i == 2 else mask
            np.save(str(tmp_path / f"f{i}.npy"), small)
    got = list(video.frames_from_dirs(str(tmp_path), str(tmp_path)))
    want = list(jvideo.frames_from_dirs(str(tmp_path), str(tmp_path)))
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
