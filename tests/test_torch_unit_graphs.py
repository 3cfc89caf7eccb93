"""What lets a spalign unit's program run as CUDA graph replays, on the
CPU: segment counts that read nothing back (``index_add_`` of ones, equal
to the ``bincount`` versions they replace), constants built once a device
(equal to freshly built ones), and the rule that engages the graphs only
on a CUDA device, with the device SLIC frontend and on one rank; every
other unit runs eagerly and is counted as a unit, not as a replay.  With
a stand-in for the capture (a replay runs its stage again and copies
what it returns into the buffers the capture left, as a graph rewrites
its static outputs), the cache's policy and the graphed unit's program
run here too.  The graphs themselves run on the card only
(``tests/test_torch_cuda.py``).  Tolerance: none."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.models import drn as tdrn
from spalign_tpu_torch.ops import segments as tseg
from spalign_tpu_torch.pipeline import label_gen as tlg
from spalign_tpu_torch.utils import graphs as tgraphs
from spalign_tpu_torch.utils import timers

torch.set_num_threads(2)


def _sizes_by_bincount(ids, s):
    lead = ids.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    flat = ids.reshape(b, -1).long() + (torch.arange(b) * s)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=b * s).reshape(
        *lead, s).to(torch.int32)


def _mean_by_bincount(data, ids, s):
    vector = data.dim() == ids.dim()
    lead = ids.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    flat = (ids.reshape(b, -1).long()
            + (torch.arange(b) * s)[:, None]).reshape(-1)
    d = data.reshape(flat.shape[0], -1).to(torch.float64)
    sums = torch.zeros((b * s, d.shape[1]), dtype=torch.float64)
    sums.index_add_(0, flat, d)
    counts = torch.bincount(flat, minlength=b * s)
    out = sums / counts.clamp(min=1)[:, None].to(torch.float64)
    dtype = data.dtype if data.is_floating_point() else torch.float32
    out = out.to(dtype).reshape(*lead, s, d.shape[1])
    return out[..., 0] if vector else out


@pytest.mark.parametrize("lead,n,s,used", [
    ((2, 3), 256, 20, 20),  # every segment present
    ((4,), 100, 50, 7),  # most segments absent
    ((), 64, 9, 9),  # no leading axis
    ((3,), 49, 1, 1),  # a single segment
], ids=["full", "absent", "unbatched", "single"])
def test_segment_counts_equal_bincount(lead, n, s, used):
    g = torch.Generator().manual_seed(n + s)
    ids = torch.randint(0, used, (*lead, n), generator=g).to(torch.int32)
    torch.testing.assert_close(tseg.segment_sizes(ids, s),
                               _sizes_by_bincount(ids, s), rtol=0, atol=0)
    for data in (torch.rand((*lead, n), generator=g),
                 torch.rand((*lead, n, 3), generator=g, dtype=torch.float64),
                 torch.randint(0, 255, (*lead, n), generator=g)):
        torch.testing.assert_close(tseg.segment_mean(data, ids, s),
                                   _mean_by_bincount(data, ids, s),
                                   rtol=0, atol=0)


def _fresh_stats():
    return (torch.tensor(tdrn.IMAGENET_MEAN, dtype=torch.float32),
            torch.tensor(tdrn.IMAGENET_STD, dtype=torch.float32))


@pytest.mark.parametrize("cached,args,use,fresh", [
    (tdrn.imagenet_stats, (torch.device("cpu"),),
     lambda: tdrn.preprocess_imagenet(torch.zeros(2, 4, 4, 3)),
     _fresh_stats),
    (tslic.grid_centers, (224, 224, 100, torch.device("cpu")),
     lambda: tslic.slic_inputs(torch.zeros(2, 224, 224, 3), 100),
     lambda: torch.from_numpy(tslic._init_centers(224, 224, 100)[0])),
    (tlg.bit_weights, (torch.device("cpu"),),
     lambda: tlg.pack_mask_bits(torch.ones(2, 3, 16, dtype=torch.bool)),
     lambda: torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                          dtype=torch.int32)),
], ids=["imagenet_stats", "grid_centers", "bit_weights"])
def test_device_constants_are_built_once(cached, args, use, fresh):
    """Each constant equals the tensor its caller used to build on every
    call, and the caller's repeated calls build it once."""
    cached.cache_clear()
    use()
    use()
    assert cached.cache_info().misses == 1 and cached.cache_info().hits >= 1
    got = cached(*args)
    assert cached(*args) is got
    want = fresh()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


HW = (32, 32)
SLIC = tcfg.SuperpixelConfig(method="slic", n_slic_segments=16, slic_iters=3,
                             slic_enforce_connectivity=False,
                             max_superpixels=64)
FELZ = tcfg.SuperpixelConfig(felzenszwalb_scale=100.0, max_superpixels=64)


def _cfg(case):
    cfg = tcfg.LabelGenConfig(resize_shape=HW, batchsize=2,
                              groups_per_dispatch=2, model_dtype="float32",
                              superpixel=SLIC, save_masks=False,
                              kmeans=tcfg.KMeansConfig(n_iter=20))
    if case == "parity":
        return dataclasses.replace(
            cfg, superpixel=FELZ, kmeans=tcfg.KMeansConfig(
                n_iter=20, init="reference"))
    if case == "host_engine":
        return dataclasses.replace(cfg, superpixel=FELZ)
    return cfg


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3),
                                               dtype=np.uint8)


class _Frames:
    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def resized_batch(self, indices, hw):
        return self.frames[list(indices)], None


@pytest.mark.parametrize("case", ["device_slic", "parity", "host_engine",
                                  "group"])
def test_cpu_units_run_eagerly_and_are_counted(case, tmp_path):
    """On the CPU every mode's unit runs eagerly: ``label.units`` counts
    each unit's program (two units of two groups, one of the parity
    mode's single group a unit), ``label.unit_replays`` none, and no
    graph is captured."""
    group = None
    if case == "group":
        tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                 rank=0, world_size=1)
        group = tdist.group.WORLD
    try:
        gen = tlg.SpalignLabelGenerator(_cfg(case), device="cpu",
                                        group=group)
        timers.reset()
        recs = gen.process_dataset(_Frames(_images(8)), save=False)
    finally:
        if group is not None:
            tdist.destroy_process_group()
    c = timers.counts()
    units = sum(1 + r for r in [recs[i]["retries"]
                                for i in range(0, 8, 2 if case == "parity"
                                               else 4)])
    assert len(recs) == 8
    assert c["label.units"] == units >= (4 if case == "parity" else 2)
    assert c.get("label.unit_replays", 0) == 0 and not gen._graphs


@pytest.mark.parametrize("case,engaged", [
    ("device_slic", True), ("parity", False), ("host_engine", False),
    ("group", False), ("cpu", False), ("given_maps", False),
])
def test_graphs_engage_only_without_host_input_or_collective(case, engaged):
    """The rule ``run_unit`` follows, read with the device set to CUDA:
    the graphs engage with the device SLIC frontend on one rank, never in
    the parity mode, with a host engine's maps or over a process group,
    nor on the CPU."""
    gen = tlg.SpalignLabelGenerator(
        _cfg(case if case in ("parity", "host_engine") else "device_slic"),
        device="cpu")
    if case != "cpu":
        gen.device = torch.device("cuda")
    if case == "group":
        gen.group = object()
    sps = torch.zeros(4, *HW, dtype=torch.int32) if case == "given_maps" \
        else None
    assert gen._graphed(sps) is engaged


class _Replay:
    """A stand-in graph of one stage over a program's buffers."""

    def __init__(self, stage, bufs):
        self.stage, self.bufs = stage, bufs

    def replay(self):
        for name, value in self.stage(self.bufs).items():
            for dst, src in zip(tgraphs._tensors(self.bufs[name]),
                                tgraphs._tensors(value)):
                dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """``utils.graphs.capture`` replaced: the stages run once, each
    becomes a ``_Replay``; returns the list of the captured stages."""
    captured = []

    def capture(stages, bufs, counted):
        captured.append(stages)
        for stage in stages:
            bufs.update(stage(bufs))
        return ([_Replay(stage, bufs) for stage in stages],
                [[0] * len(counted) for _ in stages])

    monkeypatch.setattr(tgraphs, "capture", capture)
    return captured


def _double(bufs):
    return {"y": bufs["x"] * 2}


def test_graph_cache_keeps_the_newest_and_copies_inputs_in(stand_in,
                                                           monkeypatch):
    """A hit returns the same entry, captures nothing and copies the new
    inputs into its static buffers; past the bound the least recently
    used entry goes; ``reconfigure`` empties the generator's cache."""
    cache = tgraphs.GraphCache(2, counted=())
    x = torch.ones(3)
    first = cache.load("a", (_double,), {"x": x})
    assert first.bufs["x"] is not x and len(stand_in) == 1
    hit = cache.load("a", (_double,), {"x": torch.full((3,), 5.0)})
    assert hit is first and len(stand_in) == 1
    hit.replay(0)
    assert torch.equal(hit.bufs["y"], torch.full((3,), 10.0))
    assert torch.equal(x, torch.ones(3))
    for key in ("b", "a", "c"):
        cache.load(key, (_double,), {"x": torch.zeros(3)})
    assert list(cache.entries) == ["a", "c"]
    assert len(stand_in) == 3

    gen = tlg.SpalignLabelGenerator(_cfg("device_slic"), device="cpu")
    monkeypatch.setattr(gen, "_graphed", lambda sps: True)
    gen.run_unit(torch.from_numpy(_images(4)), [1, 2])
    assert len(gen._graphs) == 1 and gen._unit is not None
    gen.set_n_clusters(3)
    assert len(gen._graphs) == 0 and gen._unit is None


def _zero_half(out):
    out[out.shape[0] // 2:] = 0
    return out


def _rolled(out):
    return out.roll(1, 0)


@pytest.mark.parametrize("wrap", [None, _rolled, _zero_half],
                         ids=["own", "replaced", "changed_in_place"])
def test_stand_in_graphed_unit_equals_the_eager_unit(stand_in, monkeypatch,
                                                     wrap):
    """Two units of 2 x 2 through the graphed program with the stand-in
    capture (the capturing call, then a replay with another wire and
    other seeds) equal their eager runs bit for bit, with ``features``
    as it is, wrapped to return other features, or wrapped to change its
    result in place (either must reach the masks); one capture of three
    stages, no result in a static buffer."""
    gen = tlg.SpalignLabelGenerator(_cfg("device_slic"), device="cpu")
    if wrap is not None:
        real = gen.features
        monkeypatch.setattr(gen, "features", lambda im: wrap(real(im)))
    units = [(torch.from_numpy(_images(4, seed)), [11 + seed, 21 + seed])
             for seed in (0, 1)]
    want = [gen.run_unit(w, s) for w, s in units]
    monkeypatch.setattr(gen, "_graphed", lambda sps: True)
    timers.reset()
    got = [gen.run_unit(w, s) for w, s in units]
    c = timers.counts()
    assert c["label.units"] == c["label.unit_replays"] == 2
    assert [len(stages) for stages in stand_in] == [3]
    static = {t.data_ptr() for v in gen._unit.bufs.values()
              for t in tgraphs._tensors(v)}
    for g, w in zip(got, want):
        for name in ("road", "road_packed", "cluster", "assign", "ok",
                     "superpixels"):
            torch.testing.assert_close(g[name], w[name], rtol=0, atol=0,
                                       msg=name)
            assert g[name].data_ptr() not in static, name
        for a, b in zip(g["res"], w["res"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
            assert a.data_ptr() not in static
