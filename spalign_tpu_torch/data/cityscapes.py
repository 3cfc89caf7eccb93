"""Cityscapes readers: directory-, zip- and file-list-backed.

Counterpart of ``spalign_tpu/data/cityscapes.py`` with the same classes
and methods:

- images matched to labels by the ``city_seq_frame`` key;
- zip-backed random access with a zip handle per thread (a ZipFile
  cannot be shared across threads);
- images resized to the working resolution with cv2's cubic filter
  (``native.resize_cubic_u8``); labels stay full resolution for
  evaluation;
- optional standardization with the Cityscapes channel statistics.

Images decode with the port's PNG reader (``data/png.py``) in place of
cv2, so only PNG files are read.  The frames of a batch
(``resized_batch``, ``full_images``) decode on a pool of up to
``DECODE_THREADS`` threads: zlib and the host library release the GIL.

Every reader returns (image, label): the image (H, W, 3) RGB float32,
the label (H, W) int32 in {-1, 0, 1}.
"""

from __future__ import annotations

import glob
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from spalign_tpu_torch import native
from spalign_tpu_torch.data.labels import create_label_mask
from spalign_tpu_torch.data.png import decode_png

# Channel statistics of the Cityscapes train split (RGB), as used by the
# reference (datasets/zipped_cityscapes_road_dataset.py:37-46).
CITYSCAPES_MEAN = np.array([73.15835921071367, 82.90891754262415,
                            72.39239876194161], dtype=np.float32)
CITYSCAPES_STD = np.array([41.61211675686322, 42.21582767516605,
                           40.48309952494058], dtype=np.float32)
DECODE_THREADS = 8


def _key(path: str) -> str:
    return "_".join(os.path.basename(path).split("_")[:3])


def _read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _map_batch(fn, indices):
    """[fn(i) for i in indices] on up to DECODE_THREADS threads."""
    indices = list(indices)
    if len(indices) <= 1:
        return [fn(i) for i in indices]
    with ThreadPoolExecutor(min(DECODE_THREADS, len(indices))) as ex:
        return list(ex.map(fn, indices))


class _LazyZip:
    """A zip file opened lazily, once per thread."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise ValueError(f"{path} does not exist")
        self.path = path
        self._local = threading.local()

    def read(self, name: str) -> bytes:
        zf = getattr(self._local, "zf", None)
        if zf is None:
            zf = zipfile.ZipFile(self.path)
            self._local.zf = zf
        return zf.read(name)

    def namelist(self):
        with zipfile.ZipFile(self.path) as zf:
            return zf.namelist()


class _PairedImages:
    """The methods the three readers share.  Subclasses set
    ``img_fns``, ``label_fns`` (None without labels), ``resize_shape``,
    ``standardize`` and implement ``_read_image`` / ``_read_label``
    (bytes of the i-th file)."""

    def __len__(self):
        return len(self.img_fns)

    def image_name(self, i):
        return self.img_fns[i]

    def label_name(self, i):
        return self.label_fns[i] if self.label_fns else None

    def _image(self, i):
        return decode_png(self._read_image(i))

    def _label(self, i):
        return decode_png(self._read_label(i), color=False)

    def __getitem__(self, i):
        return _finish(self._image(i), self._label(i), self.resize_shape,
                       self.standardize)

    def resized_batch(self, indices, resize_hw):
        """Label-generation entry: (B, h, w, 3) uint8 images at
        ``resize_hw`` and the full-resolution raw labelIds (B, H, W)
        (None without labels; the remap happens downstream)."""
        def one(i):
            img = native.resize_cubic_u8(self._image(i), resize_hw)
            return img, (self._label(i) if self.label_fns else None)

        items = _map_batch(one, indices)
        labels = ([lab for _, lab in items] if self.label_fns else None)
        return (np.stack([img for img, _ in items]).astype(np.uint8),
                None if labels is None else np.stack(labels))

    def full_images(self, indices):
        return _map_batch(self._image, indices)


class CityscapesRoadDataset(_PairedImages):
    """Directory-backed: <root>/{gtFine,leftImg8bit}/<split>/<city>/...
    (reference datasets/cityscapes_road_dataset.py)."""

    def __init__(self, data_dir: str, resize_shape, resol: str = "gtFine",
                 split: str = "val", standardize: bool = True):
        if not os.path.exists(data_dir):
            raise ValueError(f"{data_dir} does not exist")
        self.label_fns = sorted(glob.glob(os.path.join(
            data_dir, resol, split, "*", "*labelIds.png")))
        img_dir = os.path.join(data_dir, "leftImg8bit", split)
        self.img_fns = [
            os.path.join(img_dir, os.path.basename(lab).split("_")[0],
                         _key(lab) + "_leftImg8bit.png")
            for lab in self.label_fns]
        self.resize_shape = tuple(resize_shape)
        self.standardize = standardize

    def _read_image(self, i):
        return _read_file(self.img_fns[i])

    def _read_label(self, i):
        return _read_file(self.label_fns[i])


class ZippedCityscapesRoadDataset(_PairedImages):
    """Zip-backed images + gtFine labels
    (reference datasets/zipped_cityscapes_road_dataset.py)."""

    def __init__(self, img_zip: str, label_zip: str, resize_shape,
                 standardize: bool = True):
        self.img_zip = _LazyZip(img_zip)
        self.label_zip = _LazyZip(label_zip)
        label_fns = {_key(f): f for f in self.label_zip.namelist()
                     if f.endswith("labelIds.png")}
        img_fns = {_key(f): f for f in self.img_zip.namelist()
                   if f.endswith("leftImg8bit.png")}
        keys = sorted(img_fns.keys() if len(img_fns) < len(label_fns)
                      else label_fns.keys())
        self.img_fns = [img_fns[k] for k in keys]
        self.label_fns = [label_fns[k] for k in keys]
        self.resize_shape = tuple(resize_shape)
        self.standardize = standardize

    def _read_image(self, i):
        return self.img_zip.read(self.img_fns[i])

    def _read_label(self, i):
        return self.label_zip.read(self.label_fns[i])


class FileListDataset(_PairedImages):
    """Paths from .txt file lists (data/random300_images.txt style,
    reference ResizeImageDataset + TupleDataset path,
    batch_spalign_kmeans.py:492-499)."""

    def __init__(self, img_list_fn: str, label_list_fn: Optional[str],
                 resize_shape, standardize: bool = False):
        with open(img_list_fn) as f:
            self.img_fns = [line.strip() for line in f if line.strip()]
        self.label_fns = None
        if label_list_fn:
            with open(label_list_fn) as f:
                self.label_fns = [line.strip() for line in f
                                  if line.strip()]
        self.resize_shape = tuple(resize_shape)
        self.standardize = standardize

    def _read_image(self, i):
        return _read_file(self.img_fns[i])

    def _read_label(self, i):
        return _read_file(self.label_fns[i])

    def __getitem__(self, i):
        if not self.label_fns:
            img = native.resize_cubic_u8(self._image(i), self.resize_shape)
            return img.astype(np.float32), None
        return super().__getitem__(i)


def _finish(img, label_ids, resize_hw, standardize):
    img = native.resize_cubic_u8(img, resize_hw).astype(np.float32)
    if standardize:
        img = (img - CITYSCAPES_MEAN) / CITYSCAPES_STD
    return img, create_label_mask(label_ids)
