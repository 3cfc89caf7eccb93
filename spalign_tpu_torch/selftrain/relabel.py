"""Relabeling: a trained SegNet re-predicts pseudo-labels for the train
set (counterpart of ``spalign_tpu/selftrain/relabel.py``; the
reference's labels_from_segnet.py + the run_train_rounds write path).

The reference predicts image by image in one process per GPU and funnels
every result through a queue to a writer process that holds them all in
memory for one np.savez at the end (run_train_rounds.py:191-235).  Here
batches run on one device, and a background writer streams each (pred,
score) pair into the output zip as .npy members, so memory stays bounded
by the queue depth.

Under a process group (``torchrun``; the JAX package's ``mesh=``) each
rank loads and predicts its contiguous shard of every batch; the PRED
bits, the scores and the confusions go to rank 0, which alone writes the
zip, ``result.json`` and the ``save_each`` files, so the zip's members
are a one-rank run's.  Each rank writes the panels of its own images.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO
from typing import Optional

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.eval.results import ResultWriter
from spalign_tpu_torch.models.segnet import predict_labels
from spalign_tpu_torch.parallel import dist as pdist
from spalign_tpu_torch.pipeline.wire import decode_yuv420
from spalign_tpu_torch.utils.device import full_float32
from spalign_tpu_torch.utils.timers import StageTimer
from spalign_tpu_torch.utils.viz import save_prediction_panel

_SCORE_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float16): torch.float16}
LOAD_THREADS = 8  # images of a batch decoded in parallel


def _one_minus(a: np.ndarray) -> np.ndarray:
    """``1 - a`` in a's dtype; float16 through the host library's bit
    table (bit-equal to the float32 chain)."""
    if a.dtype == np.float16:
        return native.one_minus_f16(a)
    return (1.0 - a.astype(np.float32)).astype(a.dtype)


class NpzShardWriter:
    """Streamed .npz-compatible writer: a zip of .npy members, written
    one at a time from a background thread (readable by ``np.load`` and
    by ``data.estimated._NpyZipStore``)."""

    def __init__(self, path: str, depth: int = 16):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def put(self, name: str, array: np.ndarray):
        if self._err:
            raise self._err
        self._q.put((name, array))

    def _run(self):
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                name, arr = item
                buf = BytesIO()
                np.lib.format.write_array(buf, np.asarray(arr),
                                          allow_pickle=False)
                self._zf.writestr(name + ".npy", buf.getvalue())
        except Exception as e:  # surfaced on the next put or close
            self._err = e
            while self._q.get() is not None:  # let put() and close() end
                pass

    def close(self):
        self._q.put(None)
        self._thread.join()
        self._zf.close()
        if self._err:
            raise self._err


def relabel_dataset(model, variables, dataset, out_zip: str,
                    eval_shape=(1024, 2048), batch_size: int = 8,
                    soft_label: bool = True,
                    out_dir: Optional[str] = None,
                    score_dtype=np.float32,
                    save_panels: bool = False,
                    save_each: bool = False,
                    prefetch: int = 2, in_flight: int = 2,
                    input_wire: str = "auto", standardize=None,
                    score_store: str = "eval", device="cuda"):
    """Predict labels for every image in ``dataset`` and stream them into
    ``out_zip``.

    ``model``: a SegNet module, moved to ``device``; ``variables``: its
    state_dict to load first (``checkpoints.load_predictor``), or None
    to predict with the weights it holds.  ``dataset[i]`` returns
    (standardized image at the input resolution, gt labels in {-1, 0, 1}
    at ``eval_shape`` or None); ``dataset.image_name(i)`` names the
    outputs.  device: 'cuda' (default; raises without CUDA) or 'cpu'.

    Pipeline (as ``pipeline/label_gen.py``'s): one producer thread loads
    ``prefetch`` batches ahead (the images of a batch on up to
    ``LOAD_THREADS`` threads) and up to ``in_flight`` batches are
    dispatched before the oldest one's results are waited for: their
    copies to the host are pinned and non-blocking.

    input_wire: what crosses to the device.  The standardized images came
    from uint8 pixels through (x - mean) / std, so ``"u8"`` inverts that
    on the host, ships the uint8 pixels and standardizes again in
    float32 on the device (the same arithmetic); ``"auto"`` (default)
    checks the inversion on the first batch against ``standardize``
    (default: the Cityscapes statistics) and takes ``"u8"`` when it is
    exact within 1e-4, else ``"f32"``.  ``"f16"`` is lossy and opt-in.
    ``"yuv420"`` recovers the pixels as ``"u8"`` does and ships BT.601
    planes with 2x2-subsampled chroma (1.5 B/px, ``pipeline/wire.py``),
    decoded on the device: lossy, opt-in.

    Scores: for two classes only channel 0 comes to the host, in
    ``score_dtype``; channel 1 is rebuilt there as ``1 - ch0`` (softmax
    sums to one; bilinear interpolation keeps that), and the stored
    array holds both, (2, H, W), as the reference's format does
    (labels_from_segnet.py:91-95).  score_store ``"eval"`` (default, the
    reference's format) stores them at ``eval_shape``: the device's
    half-pixel bilinear upsample of the softmax, the one its argmax
    reads, cast after the upsample.  ``"network"`` stores the network
    output resolution (no information is lost: the eval-resolution array
    is its interpolation, and the training reader resizes scores to the
    input resolution anyway); the PRED members are the same in both.
    Hard-label runs (``soft_label=False``) store no scores.

    save_each: per-image ``<name>.npy`` and ``<name>_scores.npy`` files
    in ``out_dir`` (or beside ``out_zip``) instead of the zip (reference
    --save_each, run_train_rounds.py:36); the reference's own save_each
    stores the PRED under the _scores name (labels_from_segnet.py:93),
    a bug not reproduced.  save_panels: the 1x3 panel (overlay, GT,
    prediction; ``utils/viz.py``) of each image in ``out_dir``, which it
    needs, with a dataset that has ``full_images``; without them it warns
    and writes none, as the JAX package does.

    Under the default process group (``torchrun``) the batches are
    sharded over its ranks (module docstring): ``batch_size`` must divide
    by the world size, and a tail batch that does not is padded with its
    last image, whose copies are dropped again.

    Returns the per-image records: ``img_fn``, the road metrics of the
    PRED against the gt (none without gt) and the batch's host stage
    seconds (``time_load``, ``time_dispatch``, ``time_download``,
    ``time_ch1``, ``time_confusion``, ``time_write``); with ``out_dir``
    they are appended to ``out_dir/result.json`` too.  Under a group rank
    0 returns every rank's records and the others none.
    """
    dev = pdist.setup(device)  # under torchrun: joins its group
    full_float32(dev)
    group = pdist.default_group()
    world, rank = pdist.group_size(group), pdist.group_rank(group)
    pdist.shard_size(batch_size, world)
    if save_panels and not (out_dir and hasattr(dataset, "full_images")):
        warnings.warn("save_panels needs out_dir and a dataset with "
                      "full_images(); skipping panels")
        save_panels = False
    if input_wire not in ("auto", "u8", "f32", "f16", "yuv420"):
        raise ValueError(f"unknown input_wire {input_wire!r}")
    if score_store not in ("eval", "network"):
        raise ValueError(f"unknown score_store {score_store!r}")
    score_torch = _SCORE_DTYPES[np.dtype(score_dtype)]
    if standardize is None:
        from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                                       CITYSCAPES_STD)

        standardize = (CITYSCAPES_MEAN, CITYSCAPES_STD)
    std_mean = np.asarray(standardize[0], np.float32)
    std_std = np.asarray(standardize[1], np.float32)
    mean_t = torch.as_tensor(std_mean, device=dev)
    std_t = torch.as_tensor(std_std, device=dev)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev)
    on_card = dev.type == "cuda"
    eval_shape = tuple(eval_shape)
    wire = {"mode": None if input_wire == "auto" else input_wire}

    def to_u8(imgs_std):
        return native.standardize_invert_u8(imgs_std, std_mean, std_std)

    def resolve_wire(imgs_std) -> str:
        """'auto': 'u8' iff this dataset's standardization inverts
        exactly (checked on the first batch; all batches share it)."""
        if wire["mode"] is None:
            recon = (to_u8(imgs_std).astype(np.float32) - std_mean) / std_std
            err = float(np.max(np.abs(recon - imgs_std)))
            wire["mode"] = "u8" if err <= 1e-4 else "f32"
        return wire["mode"]

    each_dir = None
    writer = None
    results = None
    if rank == 0:  # the one writer of the outputs
        if save_each:
            each_dir = out_dir or (os.path.dirname(out_zip) or ".")
            os.makedirs(each_dir, exist_ok=True)
        else:
            writer = NpzShardWriter(out_zip)
        results = ResultWriter(out_dir) if out_dir else None
    n = len(dataset)
    slices = [(i, min(i + batch_size, n)) for i in range(0, n, batch_size)]

    def shard(sl):
        """This rank's rows of a batch: (indices, how many are real); the
        batch is padded with its last image to a multiple of the world
        size first."""
        idx = list(range(*sl))
        idx += idx[-1:] * (-len(idx) % world)
        local = pdist.local_rows(idx, group)
        return local, max(0, min(len(local), sl[1] - sl[0]
                                 - rank * len(local)))

    def load(sl):
        timers = StageTimer("relabel.")
        with timers.stage("load"):
            idx, n_real = shard(sl)
            with ThreadPoolExecutor(min(LOAD_THREADS, len(idx))) as pool:
                items = list(pool.map(dataset.__getitem__, idx))
            imgs = np.asarray(np.stack([it[0] for it in items]), np.float32)
            gts = (np.stack([it[1] for it in items])
                   if items[0][1] is not None else None)
            mode = resolve_wire(imgs)
            if mode == "yuv420":
                imgs_wire = native.pack_yuv420(to_u8(imgs))
            else:
                imgs_wire = (to_u8(imgs) if mode == "u8"
                             else imgs.astype(np.float16) if mode == "f16"
                             else imgs)
            host = torch.from_numpy(np.ascontiguousarray(imgs_wire))
            if on_card:
                host = host.pin_memory()
        # the resolution rides with the batch: the yuv420 planes are 1-D,
        # and the producer may load batch k+2 while k is dispatched
        return idx[:n_real], host, gts, imgs.shape[1:3], timers

    @torch.no_grad()
    def dispatch(loaded):
        idx, host, gts, hw, timers = loaded
        with timers.stage("dispatch"):
            im = host.to(dev, non_blocking=True)
            if im.dim() == 2:  # yuv420 planes
                im = decode_yuv420(im, hw)
            if im.dtype == torch.uint8:
                im = (im.to(torch.float32) - mean_t) / std_t
            labels, (score, small) = predict_labels(
                model, im.to(torch.float32), pred_shape=eval_shape,
                return_score=True, return_small_score=True)
            fetch = {"pred": labels.to(torch.bool)}
            if soft_label:
                src = score if score_store == "eval" else small
                src = src[..., :1] if src.shape[-1] == 2 else src
                fetch["score"] = src.permute(0, 3, 1, 2).to(
                    score_torch).contiguous()
            return _to_host(fetch, on_card)

    def finish(loaded, fetched):
        idx, _, gts, _, timers = loaded
        with timers.stage("download"):
            got = _landed(*fetched)
        preds = got["pred"][:len(idx)]
        scores = got.get("score")
        scores = None if scores is None else scores[:len(idx)]
        confs = None
        if gts is not None:
            gts = gts[:len(idx)]
            with timers.stage("confusion"):
                confs = [native.confusion_remapped(p, g)
                         for p, g in zip(preds, gts)]
        if save_panels:
            with timers.stage("panels"):
                for b, j in enumerate(idx):
                    save_prediction_panel(
                        out_dir, dataset.image_name(j),
                        dataset.full_images([j])[0], preds[b],
                        None if gts is None else gts[b])
        if group is not None:
            with timers.stage("gather"):
                parts = pdist.gather_objects(
                    (idx, np.packbits(preds, axis=-1), scores, confs), group)
            if rank:
                return []
            idx = [j for part in parts for j in part[0]]
            preds = np.concatenate([np.unpackbits(
                part[1], axis=-1, count=preds.shape[-1]).astype(bool)
                for part in parts])
            if scores is not None:
                scores = np.concatenate([part[2] for part in parts])
            if confs is not None:
                confs = [c for part in parts for c in part[3]]
        if scores is not None and scores.shape[1] == 1:
            with timers.stage("ch1"):
                scores = np.concatenate([scores, _one_minus(scores)], 1)
        with timers.stage("write"):
            for b, j in enumerate(idx):
                base = os.path.splitext(
                    os.path.basename(dataset.image_name(j)))[0]
                if save_each:
                    np.save(os.path.join(each_dir, base), preds[b])
                    if soft_label:
                        np.save(os.path.join(each_dir, base + "_scores"),
                                scores[b])
                else:
                    writer.put(base, preds[b])
                    if soft_label:
                        writer.put(base + "_scores", scores[b])
        stages = timers.finish()
        del stages["elapsed_time"]
        recs = []
        for b, j in enumerate(idx):
            rec = {"img_fn": dataset.image_name(j)}
            if confs is not None:
                rec.update(_scores_from_conf(confs[b]))
            rec.update(stages)
            recs.append(rec)
        if results:
            results.append_many(recs)
        return recs

    records = []
    pending = deque()
    try:
        for loaded in _prefetched(load, slices, prefetch):
            pending.append((loaded, dispatch(loaded)))
            if len(pending) > in_flight:
                records.extend(finish(*pending.popleft()))
        while pending:
            records.extend(finish(*pending.popleft()))
    finally:
        if writer is not None:
            writer.close()
    return records


def _prefetched(load, slices, depth):
    """Yield ``load(sl)`` for each slice in order, ``depth`` ahead on one
    producer thread."""
    if depth <= 0 or len(slices) <= 1:
        for sl in slices:
            yield load(sl)
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        it = iter(slices)
        futures = deque()

        def submit_next():
            sl = next(it, None)
            if sl is not None:
                futures.append(ex.submit(load, sl))

        for _ in range(depth):
            submit_next()
        while futures:
            item = futures.popleft().result()
            submit_next()
            yield item


def _to_host(fetch: dict, on_card: bool):
    """Start device tensors on their way to the host (pinned,
    non-blocking); returns (host tensors, the event to wait for)."""
    if not on_card:
        return fetch, None
    host = {}
    for name, t in fetch.items():
        host[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[name].copy_(t, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record()
    return host, landed


def _landed(host: dict, landed) -> dict:
    """Wait for ``_to_host``'s copies; numpy arrays."""
    if landed is not None:
        landed.synchronize()
    return {name: t.numpy() for name, t in host.items()}


def _scores_from_conf(conf) -> dict:
    tp, fp, fn = int(conf[1, 1]), int(conf[0, 1]), int(conf[1, 0])
    tn = int(conf[0, 0])
    return {
        "road_iou": tp / (tp + fp + fn) if tp + fp + fn else float("nan"),
        "non_road_iou": tn / (tn + fp + fn) if tn + fp + fn
        else float("nan"),
        "precision": tp / (tp + fp) if tp + fp else None,
        "recall": tp / (tp + fn) if tp + fn else None,
        "TP": tp, "FP": fp, "FN": fn,
    }
