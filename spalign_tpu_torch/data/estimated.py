"""Images + ESTIMATED labels: the self-training input.

Counterpart of ``spalign_tpu/data/estimated.py`` (the reference's
EstimatedCityscapesDataset, datasets/estimated_*.py): images paired with
``<name>.npy`` hard masks or ``<name>_scores.npy`` soft labels from the
label-generation / relabel stages, resized to the training resolution
(image bicubic, label nearest), with optional PCA-lighting +
horizontal-flip augmentation, standardized with the Cityscapes
statistics.  Labels may live in a directory, inside a zip of .npy
members, or in one .npz archive.

Images come from an image zip or directory (``**/*.png``, or the zip
members ending in ``.png``), read with the port's PNG reader, or from
a dataset object of the protocol the label generator reads,
``images[i] -> (HWC uint8, labelIds)`` and ``images.image_name(i)``
(``data/synthetic.py::SyntheticRoadScenes`` is one).  Images resize
with torch's bicubic filter in float32 (JAX: cv2's float cubic, under
the tests' tolerance), labels with the cv2-nearest convention.
"""

from __future__ import annotations

import glob
import os
import threading
import zipfile
from io import BytesIO

import numpy as np

from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                               CITYSCAPES_STD, _LazyZip,
                                               _read_file)
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.data.synthetic import resize_bicubic_f32
from spalign_tpu_torch.ops.resize import nn_resize_np

# ImageNet RGB PCA eigenvalues/eigenvectors (Krizhevsky et al. 2012) —
# the constants behind chainercv.transforms.pca_lighting.
_PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], dtype=np.float32)
_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)


def pca_lighting(img_hwc: np.ndarray, sigma: float,
                 rng: np.random.RandomState) -> np.ndarray:
    """AlexNet-style eigen-colour jitter (chainercv semantics: alpha ~
    N(0, sigma) per principal component, added to every pixel)."""
    if sigma <= 0:
        return img_hwc
    alpha = rng.normal(0, sigma, size=3).astype(np.float32)
    shift = _PCA_EIGVEC @ (alpha * _PCA_EIGVAL)
    return img_hwc + shift[None, None, :]


class _NpyZipStore:
    """Random access to .npy/.npz-packed estimated labels: a directory
    of .npy files, a zip whose members are .npy files, or one .npz
    (reference run_train_rounds.py:191-203 writes one np.savez of
    {name: pred, name+'_scores': score})."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        if os.path.isdir(path):
            self.kind = "dir"
            self._names = sorted(
                os.path.basename(f)[:-4]
                for f in glob.glob(os.path.join(path, "*.npy")))
        else:
            self.kind = "zip"
            with zipfile.ZipFile(path) as zf:
                self._names = sorted(
                    n[:-4] for n in zf.namelist() if n.endswith(".npy"))

    def names(self):
        return list(self._names)

    def load(self, name: str) -> np.ndarray:
        if self.kind == "dir":
            return np.load(os.path.join(self.path, name + ".npy"))
        zf = getattr(self._local, "zf", None)
        if zf is None:
            zf = zipfile.ZipFile(self.path)
            self._local.zf = zf
        with zf.open(name + ".npy") as f:
            return np.load(BytesIO(f.read()), allow_pickle=False)


class _PngImages:
    """The PNG files of an image directory (searched recursively) or zip,
    as a dataset object: ``[i] -> (RGB uint8, None)``, ``image_name``."""

    def __init__(self, img_source: str):
        if os.path.isdir(img_source):
            self.names = sorted(glob.glob(
                os.path.join(img_source, "**", "*.png"), recursive=True))
            self._read = _read_file
        else:
            zf = _LazyZip(img_source)
            self.names = sorted(f for f in zf.namelist()
                                if f.endswith(".png"))
            self._read = zf.read

    def __len__(self):
        return len(self.names)

    def image_name(self, i):
        return self.names[i]

    def __getitem__(self, i):
        return decode_png(self._read(self.names[i])), None


class EstimatedCityscapesDataset:
    """Images (an image zip or directory, or a dataset object) + estimated
    labels (dir/zip/npz).

    A label ``<key>.npy`` pairs with the image whose file name without
    directory and extension is ``<key>``.  use_soft_label selects the
    ``*_scores`` float arrays; otherwise the hard masks.  Items are
    (image (H, W, 3) float32 standardized, label) at ``resize_shape``."""

    def __init__(self, img_source, label_source: str, resize_shape,
                 augment: bool = False, use_soft_label: bool = False,
                 seed: int = 0):
        images = (_PngImages(img_source) if isinstance(img_source, str)
                  else img_source)
        self.images = images
        self.labels = _NpyZipStore(label_source)
        suffix = "_scores"
        names = self.labels.names()
        if use_soft_label:
            label_keys = [n for n in names if n.endswith(suffix)]
            base_names = [n[: -len(suffix)] for n in label_keys]
        else:
            label_keys = [n for n in names if not n.endswith(suffix)]
            base_names = label_keys
        img_index = {
            os.path.splitext(os.path.basename(images.image_name(i)))[0]: i
            for i in range(len(images))}
        self.img_ids, self.label_keys = [], []
        for key, name in zip(label_keys, base_names):
            base = os.path.basename(name)
            if base in img_index:
                self.img_ids.append(img_index[base])
                self.label_keys.append(key)
        if not self.img_ids:
            raise ValueError(f"no image/label pairs between {img_source} "
                             f"and {label_source}")
        self.resize_shape = tuple(resize_shape)
        self.augment = augment
        self.use_soft_label = use_soft_label
        self._seed = seed
        self._draws = 0
        self._rng_lock = threading.Lock()

    def __len__(self):
        return len(self.img_ids)

    def image_name(self, i):
        return self.images.image_name(self.img_ids[i])

    def __getitem__(self, i):
        img = np.asarray(self.images[self.img_ids[i]][0], np.float32)
        label = self.labels.load(self.label_keys[i])
        if self.use_soft_label:
            label = label.astype(np.float32)
            if label.ndim == 3 and label.shape[0] in (2, 3) \
                    and label.shape[0] < label.shape[-1]:
                label = label.transpose(1, 2, 0)  # CHW -> HWC
        else:
            label = label.astype(np.int32)

        if img.shape[:2] != self.resize_shape:
            img = resize_bicubic_f32(img, self.resize_shape)
        if label.shape[:2] != self.resize_shape:
            label = (nn_resize_np(label.transpose(2, 0, 1),
                                  self.resize_shape).transpose(1, 2, 0)
                     if label.ndim == 3
                     else nn_resize_np(label, self.resize_shape))

        if self.augment:
            # a fresh RNG per draw: RandomState is not thread-safe and the
            # prefetch loader calls __getitem__ from worker threads
            with self._rng_lock:
                self._draws += 1
                rng = np.random.RandomState(
                    (self._seed * 1000003 + self._draws) % (2 ** 31))
            img = pca_lighting(img, 25.5, rng)
            if rng.rand() > 0.5:
                img = img[:, ::-1]
                label = label[:, ::-1]

        img = (img - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return np.ascontiguousarray(img), np.ascontiguousarray(label)
