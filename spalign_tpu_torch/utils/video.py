"""Demo-video composition (reference utils/create_movie.py): overlay
predicted road masks onto frames and write an MJPG video.

Counterpart of ``spalign_tpu/utils/video.py``, which writes through
``cv2.VideoWriter``.  The port writes the same container itself: an AVI
1.0 RIFF file with one MJPG video stream (``avih``, ``strh``, ``strf``,
one ``00dc`` chunk a frame and an ``idx1`` index), each frame a baseline
JPEG of the host library (``native.encode_jpeg_rgb``).  AVI 1.0 keeps
its RIFF sizes in 32 bits and readers expect a RIFF of at most 1 GiB
(cv2 goes on past it with OpenDML's extended RIFFs): a video that would
pass ``AVI_MAX_BYTES`` raises ``ValueError`` and leaves no file.  A
Cityscapes demo sequence (~600 frames of 1024x2048) stays well under it.

The resizes are numpy copies of cv2's on uint8: ``INTER_LINEAR`` for
the frames (``size_wh``), ``INTER_NEAREST`` for the masks.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterable, Optional, Tuple

import numpy as np

from spalign_tpu_torch import native
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.pipeline.label_gen import nn_resize_np
from spalign_tpu_torch.utils.timers import StageTimer

ROAD_COLOR = (128, 64, 128)  # Cityscapes road RGB
# IJG quality of the MJPG frames.  cv2 5.0.0's MJPG VideoWriter reports
# VIDEOWRITER_PROP_QUALITY 75 on its own MJPEG backend (its default FFmpeg
# backend reports none, -1), and that backend quantizes with the Annex K
# tables divided by 0.12 * 75 = 9: IJG's quality 94 gives the tables
# nearest to those (an L1 distance of 89 over the 128 entries; 95: 93).
MJPG_QUALITY = 94
AVI_MAX_BYTES = 1 << 30
FRAMES_PER_ENCODE = 8  # frames encoded together, one a host thread


def blend_road(img_rgb: np.ndarray, mask: np.ndarray,
               alpha: float = 0.5,
               color: Tuple[int, int, int] = ROAD_COLOR) -> np.ndarray:
    """Alpha-blend the road color into masked pixels."""
    out = img_rgb.astype(np.float32).copy()
    c = np.asarray(color, np.float32)
    out[mask > 0] = (1 - alpha) * out[mask > 0] + alpha * c
    return np.clip(out, 0, 255).astype(np.uint8)


def _linear_taps(n_out: int, n_in: int):
    """cv2's INTER_LINEAR taps: source position (d + 0.5) * scale - 0.5 in
    float32, weights rounded to 11 fractional bits, indices clamped."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    w1 = np.rint(f * 2048).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * 2048).astype(np.int64)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1)


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (w, h)) (INTER_LINEAR) of an (H, W, C) uint8 image
    in cv2's fixed-point arithmetic: the horizontal pass in integers of
    11 fractional bits, the vertical pass as its vector code does it,
    ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) rounded by 2 bits."""
    h, w = out_hw
    x = np.asarray(img).astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(w, x.shape[1])
    y0, y1, b0, b1 = _linear_taps(h, x.shape[0])
    rows = (x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]) >> 4
    out = (((rows[y0] * b0[:, None, None]) >> 16)
           + ((rows[y1] * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


class MjpgAviWriter:
    """An AVI 1.0 file of one MJPG stream at ``fps``, written frame by
    frame; the headers' sizes and counts are patched in by ``close``."""

    def __init__(self, path: str, fps: int, size_wh: Tuple[int, int]):
        self.path, self.fps, self.size_wh = path, int(fps), tuple(size_wh)
        self.index = []  # (offset from 'movi', length) a frame
        self.max_frame = 0
        self.movi_size = 4  # the 'movi' fourcc and the frame chunks
        self.f = open(path, "wb")
        self.f.write(self._header())
        self.movi_at = self.f.tell() - 4  # the 'movi' fourcc

    def _header(self) -> bytes:
        w, h = self.size_wh
        n = len(self.index)
        avih = struct.pack("<10I4I", 1_000_000 // max(self.fps, 1), 0, 0,
                           0x10, n, 0, 1, self.max_frame, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MJPG", 0, 0, 0,
                           0, 1, self.fps, 0, n, self.max_frame, -1, 0, 0,
                           0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = (b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl))
        return (b"RIFF" + struct.pack("<I", self._riff_size())
                + b"AVI " + _chunk(b"LIST", hdrl) + b"LIST"
                + struct.pack("<I", self.movi_size) + b"movi")

    def _riff_size(self, extra_frames: int = 0) -> int:
        """The RIFF chunk's size: 'AVI ', the hdrl list (192 bytes), the
        movi list and the index, with ``extra_frames`` more bytes of
        frame chunks and index entries."""
        return (4 + 8 + 192 + 8 + self.movi_size + 8
                + 16 * len(self.index) + extra_frames)

    def write(self, jpeg: bytes):
        """Append one frame's JPEG; past AVI_MAX_BYTES the file is removed
        and ValueError raised."""
        size = 8 + self._riff_size(8 + len(jpeg) + (len(jpeg) & 1) + 16)
        if size > AVI_MAX_BYTES:
            self.f.close()
            os.remove(self.path)
            raise ValueError(
                f"{self.path}: {len(self.index) + 1} MJPG frames take "
                f"{size} bytes, past the AVI 1.0 limit of {AVI_MAX_BYTES} "
                f"bytes (1 GiB; cv2 writes OpenDML past it)")
        self.index.append((self.f.tell() - self.movi_at, len(jpeg)))
        self.max_frame = max(self.max_frame, len(jpeg))
        self.movi_size += 8 + len(jpeg) + (len(jpeg) & 1)
        self.f.write(_chunk(b"00dc", jpeg))

    def close(self):
        self.f.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        for offset, n in self.index:
            self.f.write(struct.pack("<4sIII", b"00dc", 0x10, offset, n))
        self.f.seek(0)
        self.f.write(self._header())
        self.f.close()


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    """A RIFF chunk, padded to an even length."""
    return (fourcc + struct.pack("<I", len(data)) + data
            + (b"\0" if len(data) & 1 else b""))


def write_overlay_video(frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                        out_fn: str, fps: int = 30,
                        size_wh: Optional[Tuple[int, int]] = None,
                        alpha: float = 0.5,
                        timers: Optional[StageTimer] = None) -> int:
    """frames yields (img_rgb uint8 HWC, mask HW); returns frame count.
    Every frame must come out at the first frame's size (or ``size_wh``).
    ``timers`` gathers the stages ``blend`` (with the resize), ``jpeg``
    (FRAMES_PER_ENCODE frames encoded at a time) and ``write``."""
    timers = timers or StageTimer()
    writer, n, pending, shape = None, 0, [], None

    def flush():
        nonlocal writer
        with timers.stage("jpeg"):
            jpegs = native.encode_jpeg_rgb(np.stack(pending), MJPG_QUALITY)
        with timers.stage("write"):
            if writer is None:
                writer = MjpgAviWriter(out_fn, fps, (pending[0].shape[1],
                                                     pending[0].shape[0]))
            for j in jpegs:
                writer.write(j)
        pending.clear()

    try:
        for img, mask in frames:
            with timers.stage("blend"):
                over = blend_road(img, mask, alpha)
                if size_wh is not None and (over.shape[1],
                                            over.shape[0]) != tuple(size_wh):
                    over = resize_linear_u8(over, (size_wh[1], size_wh[0]))
            shape = shape or over.shape
            if over.shape != shape:
                raise ValueError(f"frame {n} is {over.shape[:2]}, the video "
                                 f"{shape[:2]}")
            pending.append(over)
            n += 1
            if len(pending) == FRAMES_PER_ENCODE:
                flush()
        if pending:
            flush()
    except BaseException:
        if writer is not None and not writer.f.closed:
            writer.f.close()
            os.remove(out_fn)
        raise
    if writer is not None:
        with timers.stage("write"):
            writer.close()
    return n


def frames_from_dirs(img_dir: str, mask_dir: str):
    """Pair frame images with predicted .npy masks by basename."""
    for img_fn in sorted(glob.glob(os.path.join(img_dir, "*.png"))):
        base = os.path.splitext(os.path.basename(img_fn))[0]
        mask_fn = os.path.join(mask_dir, base + ".npy")
        if not os.path.exists(mask_fn):
            continue
        with open(img_fn, "rb") as f:
            img = decode_png(f.read())
        mask = np.load(mask_fn)
        if mask.shape != img.shape[:2]:
            mask = nn_resize_np(mask.astype(np.uint8), img.shape[:2])
        yield img, mask
