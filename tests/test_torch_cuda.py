"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere; ``python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py`` runs them on the card.  Tolerance: none.
SLIC labels are equal bit for bit (the kernels and their plain versions
do the same integer sums and the same float32 operations in the same
order, and so do the two SLIC engines); pooled values, codes and
gradients are equal bit for bit (each is one input element selected by
a compare, or zero); so are the DRN epilogue's outputs (the same float32
sums in the same order, one rounding).  The folded DRN's bf16 features
may be at most 1.1 x as far from the float32 DRN as the bf16 DRN with
its BN (the fold rounds the weights once, from float32 statistics)."""

import numpy as np
import pytest
import torch

from spalign_tpu_torch.kernels import pooling as tpk
from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.kernels import slic_assign as tsa
from spalign_tpu_torch.kernels import slic_fused as tsf
from spalign_tpu_torch.kernels.slic_fused import (slic_lloyd,
                                                  slic_lloyd_reference)
from spalign_tpu_torch.ops.pooling import max_pool_argmax_2x2, max_unpool_2x2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (marker: cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, h, w, n_seg, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.nn.functional.interpolate(
        torch.rand((b, 3, h // 8, w // 8), generator=g) * 255,
        size=(h, w), mode="bicubic").clamp(0, 255).permute(0, 2, 3, 1)
    lab = tslic.rgb_to_lab(img.to(dev) / 255.0)
    cyx, step, _, _ = tslic._init_centers(h, w, n_seg)
    cyx = torch.from_numpy(cyx).to(dev)
    c0 = torch.cat([lab[:, cyx[:, 0].long(), cyx[:, 1].long()],
                    cyx.expand(b, -1, 2)], -1).contiguous()
    labp = lab.permute(0, 3, 1, 2).reshape(b, 3, h * w).contiguous()
    return labp, c0, dict(height=h, width=w, n_iter=10,
                          ratio=10.0 / step, window=2.0 * step)


@pytest.mark.parametrize("b,h,w,n_seg", [(4, 224, 224, 100),
                                         (3, 96, 130, 40),
                                         (2, 64, 64, 128),
                                         (1, 224, 224, 100),
                                         (30, 160, 320, 100),
                                         (150, 224, 224, 100)])
def test_kernel_equals_plain_version(cuda, b, h, w, n_seg):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    before = slic_lloyd.launches
    got = slic_lloyd(lab, c0, **kw)
    torch.cuda.synchronize()
    assert slic_lloyd.launches == before + 1
    want = slic_lloyd_reference(lab, c0, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_every_cluster_size_equals_plain_version(cuda, monkeypatch, cluster):
    """The cluster size the occupancy query would pick forced: a ragged
    100x150 image (tiles cut at the edge) stays bit-equal for every C."""
    lab, c0, kw = _inputs(cuda, 3, 100, 150, 60)
    monkeypatch.setattr(tsf, "cluster_size", lambda *a: cluster)
    assert torch.equal(slic_lloyd(lab, c0, **kw),
                       slic_lloyd_reference(lab, c0, **kw))


def test_cluster_size_fills_the_card(cuda):
    """All of a batch's clusters fit at once at the two shapes the label
    paths run, and a lone image spreads over the largest cluster."""
    sizes = {b: tsf.cluster_size(b, h, w)
             for b, h, w in [(150, 224, 224), (30, 512, 1024), (1, 224, 224)]}
    assert sizes[30] >= 8 and sizes[1] == 16 and sizes[150] >= 2, sizes


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    lab, c0, kw = _inputs(cuda, 1, 32, 32, 9)
    import spalign_tpu_torch.kernels.slic_fused as mod

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("slic_lloyd_reference", "update_centers", "pixel_rows"):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(tsa, "center_sums", boom)
    monkeypatch.setattr(torch, "bincount", boom)
    out = slic_lloyd(lab, c0, **kw)
    assert out.shape == (1, 32 * 32) and out.min() >= 0
    assert np.all(out.cpu().numpy() < c0.shape[1])


# ---- the SLIC assignment kernel (csrc/slic_assign.cu) ----


@pytest.mark.parametrize("b,h,w,n_seg,case", [
    (3, 256, 512, 100, "grid"),
    (2, 250, 333, 100, "ragged"),  # H*W not a multiple of the block
    (2, 200, 300, 300, "grid"),  # K > 128
    (2, 96, 130, 40, "empty"),  # every window empty: the fallback
])
def test_assign_kernel_equals_plain_version(cuda, b, h, w, n_seg, case):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    kw = {k: v for k, v in kw.items() if k != "n_iter"}
    if case == "empty":
        c0 = c0.clone()
        c0[..., 3] += 10 * h
    before = tsa.slic_assign.launches
    got = tsa.slic_assign(lab, c0, **kw)
    torch.cuda.synchronize()
    assert tsa.slic_assign.launches == before + 1
    assert torch.equal(got, tsa.slic_assign_reference(lab, c0, **kw))


def _plain_sums(lab, centers, kw):
    labels = tsa.slic_assign_reference(lab, centers, **kw)
    return tsa.center_sums(tsa.pixel_rows(lab, kw["width"]), labels, centers)


@pytest.mark.parametrize("b,h,w,n_seg,case", [
    (3, 256, 512, 100, "grid"),
    (2, 250, 333, 100, "after_2_sweeps"),  # ragged H*W, moved centres
    (2, 300, 600, 1000, "grid"),  # K = 990
    (2, 300, 600, 1000, "after_2_sweeps"),
    (2, 96, 130, 40, "empty"),  # every window empty: global atomics
    (8, 512, 1024, 1024, "grid"),  # K = 1,035: bench.py's overlaps_slic
    (8, 512, 1024, 1024, "after_2_sweeps"),
    (1, 128, 128, 4096, "after_2_sweeps"),  # K = 4,096 at a 2 px step
    (2, 160, 200, 1000, "packed"),  # tiles past STAGE_CAP survivors
])
def test_fused_sums_equal_center_sums(cuda, b, h, w, n_seg, case):
    """The kernel's int64 sums against bincount's over the plain labels,
    and its labels against the plain labels, at any K: "packed" puts
    every centre in the top-left 48 x 48 pixels, so the tiles there hold
    more survivors than a block stages (the scan of every centre from
    device memory) and the pixels far from it have empty windows."""
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    kw = {k: v for k, v in kw.items() if k != "n_iter"}
    if case == "empty":
        c0 = c0.clone()
        c0[..., 3] += 10 * h
    elif case == "packed":
        c0 = c0.clone()
        c0[..., 3] *= 48.0 / h
        c0[..., 4] *= 48.0 / w
        assert int(tsa.tile_candidates(c0, h, w, tsa.TILE, kw["window"])
                   .sum(-1).max()) > tsa.STAGE_CAP
    elif case == "after_2_sweeps":
        for _ in range(2):
            c0 = tsa.update_centers(tsa.pixel_rows(lab, w),
                                    tsa.slic_assign_reference(lab, c0, **kw),
                                    c0)
    before = (tsa.slic_assign.launches, tsa.slic_assign.sums_launches)
    sums = tsa.slic_assign(lab, c0, sums=True, **kw)
    labels = tsa.slic_assign(lab, c0, **kw)
    torch.cuda.synchronize()
    assert (tsa.slic_assign.launches,
            tsa.slic_assign.sums_launches) == (before[0] + 2, before[1] + 1)
    assert sums.shape == (b, c0.shape[1], 6) and sums.dtype == torch.int64
    assert torch.equal(sums, _plain_sums(lab, c0, kw))
    assert torch.equal(labels, tsa.slic_assign_reference(lab, c0, **kw))


@pytest.mark.parametrize("b,h,w,n_seg", [(4, 224, 224, 100),
                                         (3, 96, 130, 40),
                                         (30, 512, 1024, 100)])
def test_engines_equal_on_the_card(cuda, b, h, w, n_seg):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    before = (tsa.slic_assign.launches, tsa.slic_assign.sums_launches)
    sweep = tslic.slic_per_sweep(lab, c0, **kw)
    assert (tsa.slic_assign.launches, tsa.slic_assign.sums_launches) == (
        before[0] + kw["n_iter"] + 1, before[1] + kw["n_iter"])
    assert torch.equal(sweep, slic_lloyd(lab, c0, **kw))


def test_overlaps_batch_launches_the_assignment_kernel(cuda):
    """One overlaps batch: n_iter + 1 assignment launches, full-res
    masks."""
    from spalign_tpu_torch import config
    from spalign_tpu_torch.pipeline.direct import make_label_generator

    sp = config.SuperpixelConfig(method="slic", n_slic_segments=40,
                                 slic_iters=3,
                                 slic_enforce_connectivity=False)
    gen = make_label_generator(config.LabelGenConfig(
        mode="overlaps", batchsize=2, resize_shape=(112, 112),
        upload_format="yuv420", superpixel=sp, save_masks=False))
    g = torch.Generator().manual_seed(0)
    full = (torch.rand((2, 128, 256, 3), generator=g) * 255).to(
        torch.uint8).numpy()
    imgs = full[:, :112, :112]
    before = tsa.slic_assign.launches
    road, _, diag, _ = gen.run_batch(imgs, full_images=full)
    torch.cuda.synchronize()
    assert tsa.slic_assign.launches == before + sp.slic_iters + 1
    assert road.shape == (2, 128, 256) and road.is_cuda
    assert diag["n_superpixels"] == [36, 36]


def test_assign_never_takes_the_plain_path(cuda, monkeypatch):
    lab, c0, kw = _inputs(cuda, 2, 64, 96, 40)

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("slic_assign_reference", "center_sums", "update_centers",
                 "pixel_rows"):
        monkeypatch.setattr(tsa, name, boom)
    monkeypatch.setattr(torch, "bincount", boom)
    out = tslic.slic_per_sweep(lab, c0, **kw)
    assert out.shape == (2, 64 * 96) and int(out.min()) >= 0
    assert int(out.max()) < c0.shape[1]


# ---- the host superpixel engines and the native scorer on the card ----


def _host_engine_generators(sp):
    from spalign_tpu_torch import config
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator

    cfg = config.LabelGenConfig(batchsize=3, resize_shape=(112, 112),
                                model_dtype="float32", save_masks=False,
                                superpixel=config.SuperpixelConfig(**sp))
    return (SpalignLabelGenerator(cfg),
            SpalignLabelGenerator(cfg, device="cpu"))


def _scenes(n, shape=(128, 256)):
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    return SyntheticRoadScenes(n=n, full_shape=shape, seed=17)


@pytest.mark.parametrize("sp", [
    dict(method="felzenszwalb", felzenszwalb_scale=100.0,
         max_superpixels=128),
    dict(method="slic", n_slic_segments=40, slic_iters=4,
         max_superpixels=128)], ids=["felzenszwalb", "slic_connectivity"])
def test_host_engine_unit_equals_cpu_run(cuda, sp):
    """The same unit on the card and on the CPU with the same draws: the
    superpixel maps are equal (host engines; SLIC's kernel is bit-equal
    to its plain version), and the cluster maps agree on >= 0.99 of the
    pixels: cuDNN's float32 convolutions and the CPU's sum in other
    orders, and one superpixel moved by a near-tie is ~1% of a 112^2
    image.  SLIC launches the Lloyd kernel once."""
    from spalign_tpu_torch.pipeline.label_gen import UnitDraws, draw_unit

    gpu, cpu = _host_engine_generators(sp)
    imgs = _scenes(3).resized_batch(range(3), (112, 112))[0]
    before = tsf.slic_lloyd.launches
    prep_g, prep_c = gpu._host_prepare(imgs), cpu._host_prepare(imgs)
    torch.cuda.synchronize()
    assert tsf.slic_lloyd.launches == before + (sp["method"] == "slic")
    np.testing.assert_array_equal(prep_g["sps_host"], prep_c["sps_host"])
    draws = draw_unit([11], 3, 112 * 112, 128, "cpu")
    gpu._wait_ready(prep_g)
    out_g = gpu.run_unit(prep_g["wire"], [11], sps=prep_g["sps"],
                         draws=UnitDraws(*(t.to(cuda) for t in draws)))
    out_c = cpu.run_unit(prep_c["wire"], [11], draws=draws,
                         sps=prep_c["sps"])
    assert (out_g["cluster"].cpu() == out_c["cluster"]).float().mean() >= 0.99


def test_native_scorer_in_the_card_label_loop(cuda, monkeypatch):
    """The host loop scores every image with the native scorer, never the
    plain one, while the units run on the card."""
    from spalign_tpu_torch import native
    from spalign_tpu_torch.pipeline import label_gen as tlg

    def boom(*a, **k):
        raise AssertionError("plain scorer called")

    calls = []
    real = native.confusion_vs_labelids

    def spy(pred, labels):
        calls.append(pred.shape)
        return real(pred, labels)

    monkeypatch.setattr(tlg, "host_confusion_reference", boom)
    monkeypatch.setattr(native, "confusion_vs_labelids", spy)
    gpu, _ = _host_engine_generators(dict(max_superpixels=256))
    recs = gpu.process_dataset(_scenes(6), save=False)
    assert len(recs) == len(calls) == 6
    assert all(np.isfinite(r["road_iou"]) for r in recs)



class _Frames:
    """Network-size frames in memory, no GT."""

    def __init__(self, n, hw, seed=0):
        rng = np.random.RandomState(seed)
        self.frames = rng.randint(0, 256, (n, *hw, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.frames)

    def resized_batch(self, indices, hw):
        return self.frames[indices], None


def _cell_generator(dev, model_name="drn_c_26"):
    """The drn26-spalign-slic cell's generator (with ``model_name``
    "drn_d_105", drnd105-spalign-slic's): units of 5 x 30 at 224^2,
    device SLIC, yuv420, the DRN in bf16."""
    from spalign_tpu_torch.config import (AlignConfig, KMeansConfig,
                                          LabelGenConfig, PriorConfig,
                                          SuperpixelConfig)
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator

    cfg = LabelGenConfig(
        resize_shape=(224, 224), batchsize=30, groups_per_dispatch=5,
        upload_format="yuv420", model_dtype="bfloat16",
        use_feature_maps=(7,), save_masks=False,
        superpixel=SuperpixelConfig(
            method="slic", n_slic_segments=100, slic_compactness=10.0,
            slic_iters=10, slic_enforce_connectivity=False,
            max_superpixels=256),
        prior=PriorConfig(0.75, 0.5, 0.1, 0.1),
        align=AlignConfig(n_anchors=10, n_neighbors=4, append_pos=True),
        kmeans=KMeansConfig(n_clusters=4, n_iter=1000, max_retries=3))
    return SpalignLabelGenerator(cfg, model_name=model_name, device=dev)


@pytest.mark.parametrize("model_name", ["drn_c_26", "drn_d_105"])
def test_label_loop_never_synchronizes_and_times_its_units(cuda,
                                                           monkeypatch,
                                                           model_name):
    """Two units of 5 x 30 at 224^2 (the drn26-spalign-slic and
    drnd105-spalign-slic cells' shapes): no ``torch.cuda.synchronize``
    while the loop runs; each unit's device program (its device span,
    CUDA events) is over 0 and shorter than its unit's dispatch-to-land
    interval, and its backbone (the ``label.features`` device span) over 0
    and shorter than its device program."""
    from spalign_tpu_torch.utils import timers

    gen = _cell_generator(cuda, model_name)
    ds = _Frames(300, (224, 224))
    gen.process_dataset(ds)  # builds and warms every shape
    calls = []
    real = torch.cuda.synchronize

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    timers.reset()
    recs = gen.process_dataset(ds)
    assert calls == [] and len(recs) == 300
    sp = timers.spans()
    start, end = {}, {}  # a unit's first dispatch, its last landing
    for s in sp:
        u = s.ids.get("unit")
        if s.name == "label.dispatch":
            start[u] = min(start.get(u, s.start_ns), s.start_ns)
        elif s.name == "label.land":
            end[u] = max(end.get(u, s.end_ns), s.end_ns)
    device = [s for s in sp if s.name == "label.device_program"]
    assert sorted(start) == sorted(end) == [0, 1] and len(device) >= 2
    for s in device:
        u = s.ids["unit"]
        assert 0 < s.device_ns < end[u] - start[u]
    assert recs[0]["time_device_program"] > 0
    backbone = [s for s in sp if s.name == "label.features"]
    assert sorted({s.ids["unit"] for s in backbone}) == [0, 1]
    for s in backbone:
        program = [d for d in device if d.id == s.parent]
        assert len(program) == 1 and 0 < s.device_ns < program[0].device_ns
    assert timers.counts()["drn.images"] == 150 * len(backbone)

def test_label_loop_takes_no_capture_after_its_warm_pass(cuda, monkeypatch):
    """After a first pass over two units of 5 x 30 at 224^2, a second
    pass runs every k-means chunk as a replay of the graph the first
    captured, every unit's program before the k-means as replays of the
    unit graphs the first captured, and captures none."""
    from spalign_tpu_torch.ops import kmeans as tkm
    from spalign_tpu_torch.utils import graphs as tgraphs
    from spalign_tpu_torch.utils import timers

    captures = []
    real = tgraphs.capture

    def counting(stages, *a):
        captures.append(len(stages))
        return real(stages, *a)

    monkeypatch.setattr(tgraphs, "capture", counting)
    gen = _cell_generator(cuda)
    ds = _Frames(300, (224, 224))
    gen.process_dataset(ds)
    assert captures.count(3) == 1  # the unit's three stages
    captured = len(captures)
    graphs = list(tkm._GRAPHS.entries.items())
    unit_graphs = list(gen._graphs.entries.items())
    assert len(unit_graphs) == 1
    timers.reset()
    gen.process_dataset(ds)
    assert len(captures) == captured
    c = timers.counts()
    assert c["kmeans.chunks"] == c["kmeans.replays"] >= 2
    assert list(tkm._GRAPHS.entries.items()) == graphs
    assert c["label.units"] == c["label.unit_replays"] >= 2
    assert list(gen._graphs.entries.items()) == unit_graphs


# ---- a unit's stages before the k-means as CUDA graph replays
# (pipeline/label_gen.py run_unit, utils/graphs.py) ----


def _wire(dev, n, seed):
    from spalign_tpu_torch import native

    frames = _Frames(n, (224, 224), seed).frames
    return torch.from_numpy(native.pack_yuv420(frames)).to(dev)


def _run(gen, wire, seeds):
    """A unit's device tensors, with the features ``features`` gave."""
    feats = []
    real = gen.features

    def keep(images):
        feats.append(real(images).clone())
        return feats[-1]

    gen.features = keep
    try:
        out = gen.run_unit(wire, seeds)
    finally:
        del gen.features
    return dict(out, features=feats[0], n_iter=out["res"].n_iter)


_COMPARED = ("road_packed", "cluster", "assign", "features", "superpixels",
             "n_iter")


def _buffers(captured):
    """Every static buffer of a ``utils.graphs.Captured``."""
    return [t for v in captured.bufs.values()
            for t in (v if isinstance(v, tuple) else (v,))]


def _assert_units_equal(got, want):
    for name in _COMPARED:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0,
                                   msg=name)


def _eager(gen, monkeypatch):
    monkeypatch.setattr(gen, "_graphed", lambda sps: False)
    return gen


@pytest.mark.parametrize("model_name,groups,batch", [
    ("drn_c_26", 5, 30), ("drn_d_105", 2, 6)])
def test_graphed_unit_equals_the_eager_unit(cuda, monkeypatch, model_name,
                                            groups, batch):
    """The drn26-spalign-slic cell's unit (5 x 30 at 224^2) and a small
    DRN-D-105 unit (2 x 6), graphed (the capturing call and a replay)
    and eager: equal packed masks, cluster maps, assignments, features,
    superpixel maps and k-means sweeps, bit for bit.  The Lloyd kernel's
    launch count counts every run of it, the capture's warm run and each
    replay included."""
    import dataclasses

    from spalign_tpu_torch.utils import timers

    gen = _cell_generator(cuda, model_name)
    gen.reconfigure(dataclasses.replace(gen.cfg, batchsize=batch,
                                        groups_per_dispatch=groups))
    wire = _wire(cuda, groups * batch, 1)
    seeds = [np.uint32(11 + g) for g in range(groups)]
    timers.reset()
    launches = tsf.slic_lloyd.launches
    first = _run(gen, wire, seeds)
    assert tsf.slic_lloyd.launches == launches + 2
    second = _run(gen, wire, seeds)
    assert tsf.slic_lloyd.launches == launches + 3
    c = timers.counts()
    assert c["label.units"] == c["label.unit_replays"] == 2
    assert len(gen._graphs) == 1
    want = _run(_eager(gen, monkeypatch), wire, seeds)
    assert tsf.slic_lloyd.launches == launches + 4
    assert timers.counts()["label.unit_replays"] == 2
    _assert_units_equal(first, want)
    _assert_units_equal(second, want)


def test_graphed_units_never_alias_the_graph_buffers(cuda, monkeypatch):
    """Two units of the cell's shape with other wires and seeds back to
    back, then a retry of the first with fresh seeds: the first unit's
    results are unchanged after the others ran, no returned tensor lies
    in a static buffer of the unit's or the Lloyd loop's graphs, and each
    unit equals its eager run."""
    from spalign_tpu_torch.ops import kmeans as tkm

    gen = _cell_generator(cuda)
    wires = [_wire(cuda, 150, 2), _wire(cuda, 150, 3)]
    runs = [(wires[0], [np.uint32(21 + g) for g in range(5)]),
            (wires[1], [np.uint32(31 + g) for g in range(5)]),
            (wires[0], [np.uint32(41 + g) for g in range(5)])]
    outs = [_run(gen, w, s) for w, s in runs[:1]]
    kept = {k: outs[0][k].clone() for k in _COMPARED}
    outs += [_run(gen, w, s) for w, s in runs[1:]]
    (unit,) = gen._graphs.entries.values()
    static = _buffers(unit) + [t for chunk in tkm._GRAPHS.entries.values()
                               for t in _buffers(chunk)]
    assert len(_buffers(unit)) == 18
    spans = [(t.untyped_storage().data_ptr(),
              t.untyped_storage().data_ptr() + t.untyped_storage().nbytes())
             for t in static]
    for out in outs:
        for name, t in out.items():
            ts = t if isinstance(t, tuple) else (t,)
            for x in ts:
                p = x.untyped_storage().data_ptr()
                assert not any(lo <= p < hi for lo, hi in spans), name
    torch.cuda.synchronize()
    _assert_units_equal(outs[0], kept)
    eager = _eager(gen, monkeypatch)
    for out, (w, s) in zip(outs, runs):
        _assert_units_equal(out, _run(eager, w, s))


def test_unit_dispatch_reads_nothing_back(cuda, monkeypatch):
    """After the warm pass, a pass of two units of 5 x 30 at 224^2 runs
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing the label
    loop does waits for the card but the host's k-means checks
    (``kmeans.check``) and the landing of a unit's results
    (``label.land``)."""
    import contextlib

    from spalign_tpu_torch.ops import kmeans as tkm
    from spalign_tpu_torch.pipeline import label_gen as tlg

    gen = _cell_generator(cuda)
    ds = _Frames(300, (224, 224))
    gen.process_dataset(ds)
    waits = []

    def allowing(real):
        def span(name, **ids):
            if name not in ("kmeans.check", "label.land"):
                return real(name, **ids)
            return allowed(real(name, **ids), name)
        return span

    @contextlib.contextmanager
    def allowed(inner, name):
        waits.append(name)
        torch.cuda.set_sync_debug_mode(0)
        try:
            with inner:
                yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(tkm, "span", allowing(tkm.span))
    monkeypatch.setattr(tlg, "span", allowing(tlg.span))
    torch.cuda.set_sync_debug_mode("error")
    try:
        recs = gen.process_dataset(ds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(recs) == 300
    assert waits.count("label.land") >= 2 and "kmeans.check" in waits


# ---- the k-means Lloyd loop as CUDA graph replays (ops/kmeans.py) ----


def _lloyd_groups(dev, seed, n=3000, d=514):
    """Five groups at the cell's k-means shape, (5, 3000, 514) float32:
    four far blobs (a few sweeps), one point repeated (a cluster empties
    in the first sweep) and three of eight close blobs each (tens of
    sweeps); 40 padded rows a group."""
    g = torch.Generator().manual_seed(seed)

    def blobs(n_blobs, spread):
        c = torch.randn(n_blobs, d, generator=g) * spread
        lab = torch.randint(0, n_blobs, (n,), generator=g)
        return c[lab] + torch.randn(n, d, generator=g)

    X = torch.stack([blobs(4, 10.0), blobs(1, 1.0)[:1].expand(n, d),
                     blobs(8, 0.1), blobs(8, 0.1), blobs(8, 0.1)])
    w = torch.rand(5, n, generator=g)
    valid = torch.ones(5, n, dtype=torch.bool)
    valid[:, -40:] = False
    u = torch.rand(5, n, generator=g)
    return X.to(dev), w.to(dev), valid.to(dev), u.to(dev)


def _replays():
    from spalign_tpu_torch.utils import timers

    return timers.counts().get("kmeans.replays", 0)


@pytest.mark.parametrize("n_iter", [40, 1000])
def test_lloyd_graph_replays_equal_the_eager_loop(cuda, n_iter):
    """Chunks of 16 sweeps replayed as a CUDA graph against the same
    sweeps run one by one (one chunk longer than ``n_iter``: no replay),
    float32 with TF32 off: equal assignments, sweep counts and stop flags,
    bit-equal centres.  The groups stop within the first chunk, the
    second and later (at 40: by the sweep limit, after two replays and
    an eager chunk of 8), one on an empty cluster."""
    from spalign_tpu_torch.ops import kmeans as tkm

    X, w, valid, u = _lloyd_groups(cuda, 1)
    before = _replays()
    want = tkm.weighted_kmeans(X, w, valid, k=4, n_iter=n_iter, uniforms=u,
                               check_every=n_iter + 1)
    assert _replays() == before
    got = tkm.weighted_kmeans(X, w, valid, k=4, n_iter=n_iter, uniforms=u,
                              check_every=16)
    assert _replays() >= before + 2
    it = want.n_iter.cpu()
    assert (it <= 16).any() and ((it > 16) & (it <= 32)).any()
    assert (it > 32).any() and bool(want.empty_stop.any())
    for name, a, b in zip(want._fields, want, got):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def test_lloyd_graph_outputs_never_alias_its_buffers(cuda):
    """Two calls of one shape with other inputs replay one graph: the
    first call's results are unchanged after the second call, and the
    second's equal its eager run."""
    from spalign_tpu_torch.ops import kmeans as tkm

    ins = _lloyd_groups(cuda, 2)
    first = tkm.weighted_kmeans(*ins[:3], k=4, uniforms=ins[3])
    kept = [t.clone() for t in first]
    ins = _lloyd_groups(cuda, 3)
    before = _replays()
    second = tkm.weighted_kmeans(*ins[:3], k=4, uniforms=ins[3])
    assert _replays() > before
    want = tkm.weighted_kmeans(*ins[:3], k=4, uniforms=ins[3],
                               check_every=1001)
    torch.cuda.synchronize()
    assert not torch.equal(first.assignment, second.assignment)
    for a, b in zip(kept, first):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(want, second):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


# ---- the SegNet pooling kernels (csrc/pooling.cu) ----


def _pool_input(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    x[x.abs() < 0.4] = 0.0  # ties, as after relu
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 64), (2, 16, 32, 512),
                                   (3, 10, 14, 64), (1, 6, 10, 3)],
                         ids=["c64", "c512", "ragged_w", "scalar_c3"])
def test_pooling_kernels_equal_plain_versions(cuda, shape, dtype):
    x = _pool_input(cuda, shape, dtype)
    before = (tpk.pool2x2.launches, tpk.scatter2x2.launches,
              tpk.gather2x2.launches)
    pooled, codes = tpk.pool2x2(x)
    p_ref, c_ref = tpk.pool2x2_reference(x)
    y = _pool_input(cuda, pooled.shape, dtype, seed=1)
    up = tpk.scatter2x2(y, codes)
    g = _pool_input(cuda, shape, dtype, seed=2)
    down = tpk.gather2x2(g, codes)
    torch.cuda.synchronize()
    assert (tpk.pool2x2.launches, tpk.scatter2x2.launches,
            tpk.gather2x2.launches) == tuple(b + 1 for b in before)
    assert torch.equal(pooled, p_ref) and torch.equal(codes, c_ref)
    assert torch.equal(up, tpk.scatter2x2_reference(y, codes))
    assert torch.equal(down, tpk.gather2x2_reference(g, codes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_odd_input_through_the_ops_layer(cuda, dtype):
    """Odd H and W: the -inf pad in the ops layer, then the kernels;
    values and gradients equal the plain CPU path's."""
    x = _pool_input(cuda, (2, 9, 13, 64), dtype)
    w = _pool_input(cuda, (2, 9, 13, 64), dtype, seed=3)
    outs = []
    for t in (x, x.cpu()):
        t = t.clone().requires_grad_(True)
        pooled, codes = max_pool_argmax_2x2(t)
        up = max_unpool_2x2(pooled * 2, codes, out_hw=(9, 13))
        (up * w.to(t.device)).sum().backward()
        outs.append((pooled, codes, up, t.grad))
    for a, b in zip(*outs):
        assert torch.equal(a.detach().cpu(), b.detach())


def test_pooling_never_takes_the_plain_path(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("pool2x2_reference", "scatter2x2_reference",
                 "gather2x2_reference"):
        monkeypatch.setattr(tpk, name, boom)
    import spalign_tpu_torch.ops.pooling as ops_pooling

    monkeypatch.setattr(ops_pooling, "pool2x2_reference", boom)
    monkeypatch.setattr(ops_pooling, "scatter2x2_reference", boom)
    x = _pool_input(cuda, (2, 8, 12, 64), torch.float32).requires_grad_(True)
    pooled, codes = max_pool_argmax_2x2(x)
    max_unpool_2x2(pooled, codes).sum().backward()
    assert x.grad.shape == x.shape


def test_segnet_basic_train_step_launch_counts(cuda, tmp_path):
    """One SegNetBasic train step: 4 pools, 8 scatters (4 unpools
    forward, 4 pool backwards), 4 gathers (4 unpool backwards)."""
    from spalign_tpu_torch.config import TrainConfig
    from spalign_tpu_torch.train.trainer import Trainer

    tr = Trainer(TrainConfig(batchsize=2, input_shape=(64, 128),
                             result_dir=str(tmp_path)))
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randn((2, 64, 128, 3), generator=g, device=cuda)
    labels = (torch.rand((2, 64, 128), generator=g, device=cuda)
              > 0.5).to(torch.int32)
    tpk.reset_launches()
    loss = tr.train_step(images, labels)["loss"]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (tpk.pool2x2.launches, tpk.scatter2x2.launches,
            tpk.gather2x2.launches) == (4, 8, 4)


# ---- the folded DRN's epilogue (kernels/drn_epilogue.py,
# csrc/drn_epilogue.cu) and the folded backbone ----


def _folded(dev, model_name, sd=None, dtype=torch.bfloat16):
    """``model_name``'s DRN (float32, on the CPU; ``sd`` its weights, else
    the factory's) and its folded form in ``dtype`` on ``dev``,
    channels_last, as the label generator builds it."""
    from spalign_tpu_torch.models import drn as tdrn

    model = tdrn.DRN_FACTORIES[model_name](device="cpu")
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    folded = tdrn.fold_drn(model, dtype).to(dev).to(
        memory_format=torch.channels_last)
    return model, folded


def _epilogue_shapes(dev, monkeypatch, model_name):
    """(C, H, W, whether a residual is added) of each epilogue of
    ``model_name``'s folded forward at 224^2, each once, in order met."""
    from spalign_tpu_torch.models import drn as tdrn

    _, folded = _folded(dev, model_name)
    seen = []
    real = tdrn.drn_epilogue

    def recording(y, bias, residual=None):
        key = (*y.shape[1:], residual is not None)
        if key not in seen:
            seen.append(key)
        return real(y, bias, residual)

    monkeypatch.setattr(tdrn, "drn_epilogue", recording)
    folded.features(torch.zeros((1, 224, 224, 3), device=dev))
    monkeypatch.setattr(tdrn, "drn_epilogue", real)
    return seen


def _channels_last(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * 3).to(dtype) \
        .contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("model_name", ["drn_c_26", "drn_d_105"])
def test_drn_epilogue_equals_plain_version_at_every_shape(cuda, monkeypatch,
                                                          model_name):
    """Every epilogue shape of the folded DRN-C-26 / DRN-D-105 at 224^2
    (the C = 16 stem first) at a ragged batch of 7: the kernel equals
    its plain version bit for bit, bfloat16 and float32, each launch
    counted."""
    from spalign_tpu_torch.kernels.drn_epilogue import (
        drn_epilogue, drn_epilogue_reference)

    shapes = _epilogue_shapes(cuda, monkeypatch, model_name)
    assert shapes[0] == (16, 224, 224, False)
    assert any(res for *_, res in shapes)
    for i, (c, h, w, res) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            y = _channels_last(cuda, (7, c, h, w), dtype, 3 * i)
            r = (_channels_last(cuda, (7, c, h, w), dtype, 3 * i + 1)
                 if res else None)
            bias = torch.randn(c, generator=torch.Generator(
                device=cuda).manual_seed(3 * i + 2), device=cuda)
            want = drn_epilogue_reference(y, bias, r)
            launches = drn_epilogue.launches
            assert drn_epilogue(y, bias, r) is y
            torch.cuda.synchronize()
            assert drn_epilogue.launches == launches + 1
            assert torch.equal(y, want), (c, h, w, res, dtype)


@pytest.mark.parametrize("case", ["nchw", "residual_nchw", "float16",
                                  "channels"])
def test_drn_epilogue_raises_on_what_it_does_not_take(cuda, case):
    """NCHW-contiguous y or residual, float16, and a C that is no
    multiple of 16 bytes raise before any launch."""
    from spalign_tpu_torch.kernels.drn_epilogue import drn_epilogue

    c = 12 if case == "channels" else 64
    y = _channels_last(cuda, (2, c, 8, 8), torch.bfloat16, 0)
    r, bias = None, torch.zeros(c, device=cuda)
    if case == "nchw":
        y = y.contiguous()
    elif case == "residual_nchw":
        r = y.clone().contiguous()
    elif case == "float16":
        y = y.to(torch.float16)
    launches = drn_epilogue.launches
    with pytest.raises(TypeError if case == "float16" else ValueError):
        drn_epilogue(y, bias, r)
    assert drn_epilogue.launches == launches


@pytest.mark.parametrize("model_name,epilogues", [("drn_c_26", 25),
                                                  ("drn_d_105", 104)])
def test_captured_folded_backbone_equals_the_eager_run(cuda, model_name,
                                                       epilogues):
    """The label generator's folded backbone (bf16, 12 images at 224^2)
    captured by ``utils/graphs.py`` and replayed equals its eager run bit
    for bit, for the captured images and for others loaded after; one
    epilogue launch a convolution output, each replay counted; the DRN
    with its BN stays on the CPU."""
    from spalign_tpu_torch.kernels.drn_epilogue import drn_epilogue
    from spalign_tpu_torch.models.drn import FoldedDRN
    from spalign_tpu_torch.utils.graphs import Captured

    gen = _cell_generator(cuda, model_name)
    assert isinstance(gen.net, FoldedDRN)
    assert next(gen.model.parameters()).device.type == "cpu"
    images = [gen.decode(_wire(cuda, 12, seed)) for seed in (5, 6)]
    before = drn_epilogue.launches
    eager = [gen.backbone(x).clone() for x in images]
    assert drn_epilogue.launches == before + 2 * epilogues
    cap = Captured([lambda b: {"feats": gen.backbone(b["images"])}],
                   {"images": images[0]}, (drn_epilogue,))
    assert cap.launches == [[epilogues]]
    for x, want in zip(images + images[:1], eager + eager[:1]):
        cap.load(images=x)
        cap.replay(0)
        torch.cuda.synchronize()
        assert torch.equal(cap.bufs["feats"], want)
    assert drn_epilogue.launches == before + 6 * epilogues


@pytest.mark.parametrize("model_name", ["drn_c_26", "drn_d_105"])
def test_folded_bf16_features_stay_within_the_bf16_drn_error(cuda,
                                                             model_name):
    """The benchmark's weights and scenes (8 of its frames at 224^2):
    the folded bf16 features' worst relative error against the float32
    DRN (TF32 off) is at most 1.1 x the bf16 DRN's (with its BN)."""
    import copy
    import json

    from perfbench import harness, scenes, weights, weights_drn_d
    from perfbench.drivers import label as pb_label
    from spalign_tpu_torch.models.drn import preprocess_imagenet

    name = {"drn_c_26": "drn26-spalign-slic",
            "drn_d_105": "drnd105-spalign-slic"}[model_name]
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    shapes = (weights.drn_shapes(cfg["model"]) if model_name == "drn_c_26"
              else weights_drn_d.drn_d_shapes(cfg["model"]))
    scene_seed, weight_seed = harness.seeds(2017, 2)
    sd = weights.make(shapes, weight_seed, "cpu", 1.0)
    frames, _ = scenes.render(scene_seed, 8, (512, 1024), cuda)
    x = preprocess_imagenet(torch.from_numpy(
        pb_label.resize_u8(frames, (224, 224), cuda)).to(cuda))
    model, folded = _folded(cuda, model_name, sd)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = copy.deepcopy(model).to(cuda).features(x)
            low = copy.deepcopy(model).to(cuda, torch.bfloat16).to(
                memory_format=torch.channels_last).features(x)
            got = folded.features(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    def rel(a):
        return float(((a - ref).flatten(1).norm(dim=1)
                      / ref.flatten(1).norm(dim=1)).max())

    print(f"{model_name} feat_rel: folded {rel(got):.5f}, "
          f"bf16 DRN {rel(low):.5f}")
    assert rel(got) <= 1.1 * rel(low)


# ---- the host library's yuv420 pack and real image files on the card ----


def test_card_label_path_packs_with_the_host_library(cuda, monkeypatch):
    """A yuv420 unit on the card is packed by native.pack_yuv420 (C++),
    never by the numpy pack, and the device decodes it to the images the
    numpy pack gives."""
    from spalign_tpu_torch import config, native
    from spalign_tpu_torch.pipeline import wire
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator

    def boom(*a, **k):
        raise AssertionError("numpy pack called")

    calls = []
    real = native.pack_yuv420

    def spy(images):
        calls.append(images.shape)
        return real(images)

    monkeypatch.setattr(wire, "pack_yuv420", boom)
    monkeypatch.setattr(native, "pack_yuv420", spy)
    cfg = config.LabelGenConfig(
        batchsize=3, resize_shape=(112, 112), upload_format="yuv420",
        save_masks=False, superpixel=config.SuperpixelConfig(
            method="slic", n_slic_segments=40, slic_iters=4,
            slic_enforce_connectivity=False))
    gen = SpalignLabelGenerator(cfg)
    imgs = _scenes(3).resized_batch(range(3), (112, 112))[0]
    prepared = gen._host_prepare(imgs)
    gen._wait_ready(prepared)
    assert calls == [imgs.shape]
    monkeypatch.undo()
    want = wire.decode_yuv420(torch.from_numpy(wire.pack_yuv420(imgs)),
                              (112, 112))
    assert torch.equal(gen.decode(prepared["wire"]).cpu(), want)


def test_train_cli_step_on_the_card_from_png_files(cuda, tmp_path):
    """One cli.train step on the card from PNG files written by the
    port's encoder: the pooling kernels launch, the loss is finite."""
    import zipfile

    from spalign_tpu_torch.cli import train as train_cli
    from spalign_tpu_torch.data.png import encode_png

    scenes = _scenes(2, (64, 128))
    img_zip, mask_dir = str(tmp_path / "imgs.zip"), tmp_path / "masks"
    mask_dir.mkdir()
    with zipfile.ZipFile(img_zip, "w") as zf:
        for i in range(2):
            img, lab = scenes[i]
            key = f"city_000000_{i:06d}_leftImg8bit"
            zf.writestr(f"train/city/{key}.png", encode_png(img))
            np.save(mask_dir / key, (lab == 7).astype(np.uint8))
    tpk.reset_launches()
    trainer, _ = train_cli.main([
        "--train_img_zip", img_zip, "--train_label_zip", str(mask_dir),
        "--batchsize", "2", "--input_shape", "32", "64", "--optimizer",
        "Adam", "--train_limit", "1", "--log_interval", "1",
        "--result_dir", str(tmp_path / "run")])
    torch.cuda.synchronize()
    assert trainer.step == 1
    assert (tpk.pool2x2.launches, tpk.scatter2x2.launches,
            tpk.gather2x2.launches) == (4, 8, 4)
    assert (tmp_path / "run" / "snapshot_iter_1").exists()


def test_relabel_on_the_card_equals_cpu_run(cuda, tmp_path):
    """relabel_dataset on the card (float32, TF32 off) against the same
    pass on the CPU: the PRED members agree on >= 0.999 of the pixels,
    channel 1 is 1 - ch0 bit for bit, the mean score delta is below 1e-3
    (single scores may move where a pooling window ties within float32
    noise), and the pass launches the pool and scatter kernels."""
    from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                                   CITYSCAPES_STD)
    from spalign_tpu_torch.models.segnet import build_segnet
    from spalign_tpu_torch.selftrain.relabel import relabel_dataset

    scenes = _scenes(4, (64, 128))

    class Std:
        def __len__(self):
            return 4

        def image_name(self, i):
            return scenes.image_name(i)

        def __getitem__(self, i):
            img, lab = scenes[i]
            img = (img.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
            return img, (lab == 7).astype(np.int32)

    state = build_segnet(device="cpu").state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        tpk.reset_launches()
        path = str(tmp_path / f"{dev}.0.zip")
        relabel_dataset(build_segnet(device=dev), state, Std(), path,
                        eval_shape=(64, 128), batch_size=3, device=dev)
        if dev == "cuda":
            assert (tpk.pool2x2.launches, tpk.scatter2x2.launches) == (8, 8)
        with np.load(path) as npz:
            out[dev] = {k: npz[k] for k in npz.files}
    deltas = []
    for k, v in out["cpu"].items():
        got = out["cuda"][k]
        if k.endswith("_scores"):
            np.testing.assert_array_equal(got[1], 1.0 - got[0])
            deltas.append(np.abs(got - v).mean())
        else:
            assert np.mean(got == v) >= 0.999, k
    assert np.mean(deltas) < 1e-3


def test_one_rank_nccl_group_is_bit_equal(cuda, tmp_path, monkeypatch):
    """Two train steps under a one-rank NCCL group equal the steps
    without a group bit for bit (deterministic cuDNN algorithms)."""
    import socket

    import torch.distributed as dist

    from spalign_tpu_torch.config import TrainConfig
    from spalign_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(0)
    imgs = rng.randn(4, 32, 64, 3).astype(np.float32)
    labels = rng.randint(-1, 2, (4, 32, 64)).astype(np.int32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    def steps():
        tr = Trainer(TrainConfig(batchsize=4, input_shape=(32, 64),
                                 result_dir=str(tmp_path)))
        losses = [float(tr.train_step(*tr.to_device(imgs, labels))["loss"])
                  for _ in range(2)]
        return losses, tr.model.state_dict()

    want_losses, want = steps()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    dist.init_process_group("nccl", init_method="env://", rank=0,
                            world_size=1)
    try:
        got_losses, got = steps()
    finally:
        dist.destroy_process_group()
    assert got_losses == want_losses
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_score_full_res_on_the_card_equals_the_cpu(cuda):
    """The device scorer on the card against its CPU run and the host
    scorer: equal (integer counts)."""
    from spalign_tpu_torch.pipeline.label_gen import (host_confusion,
                                                      score_full_res)

    rng = np.random.RandomState(0)
    road = torch.from_numpy(rng.rand(4, 56, 112) > 0.5)
    ids = torch.from_numpy(rng.randint(0, 34, (4, 256, 512)).astype(
        np.uint8))
    got = score_full_res(road.to(cuda), ids.to(cuda), (256, 512)).cpu()
    assert torch.equal(got, score_full_res(road, ids, (256, 512)))
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].numpy(), host_confusion(road[b].numpy(), ids[b].numpy()))


def test_ccl_on_the_card_equals_the_cpu(cuda):
    from spalign_tpu_torch.kernels.experimental.ccl import (
        enforce_connectivity_device)

    lab = torch.from_numpy(np.random.RandomState(1).randint(
        0, 5, (3, 64, 96)).astype(np.int32))
    for min_size in (1, 6):
        got = enforce_connectivity_device(lab.to(cuda), min_size=min_size)
        assert torch.equal(got.cpu(), enforce_connectivity_device(
            lab, min_size=min_size))


def test_exact_permutation_anchors_on_the_card(cuda):
    from spalign_tpu_torch.ops.segments import sample_segment_anchors

    sp = torch.from_numpy((np.arange(100)[:, None] // 5 * 24
                           + np.arange(120)[None] // 5).astype(np.int32))
    perm = torch.randperm(sp.numel(), generator=torch.Generator(
    ).manual_seed(0))
    got = sample_segment_anchors(sp.to(cuda), 10, 70000,
                                 random_bits=perm.to(cuda))
    want = sample_segment_anchors(sp, 10, 70000, random_bits=perm)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
