"""The port's segment, align, prior and k-means ops against the JAX
package, with the JAX package's random draws handed to the port.

Tolerances: anchors, seeding, Lloyd assignments, painting and bit
packing exact; superpixel_align 1e-5 absolute (the same bilinear weight
arithmetic, float32 sums in another order); superpixel_prior rtol 1e-6
(one-hot matmul in JAX, float64 index_add_ in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.ops import align as jalign
from spalign_tpu.ops import kmeans as jkm
from spalign_tpu.ops import prior as jprior
from spalign_tpu.ops import segments as jseg
from spalign_tpu.pipeline.label_gen import pack_mask_bits as jpack
from spalign_tpu_torch.ops import align as talign
from spalign_tpu_torch.ops import kmeans as tkm
from spalign_tpu_torch.ops import prior as tprior
from spalign_tpu_torch.ops import segments as tseg
from spalign_tpu_torch.utils import timers
from spalign_tpu_torch.pipeline.label_gen import (pack_mask_bits,
                                                  unpack_mask_bits)

torch.set_num_threads(2)

S = 36


def _superpixels(seed, h=40, w=48, s=S):
    """Blocky maps with every id present and ragged segment sizes."""
    rng = np.random.RandomState(seed)
    gy, gx = 6, 6
    ys = np.sort(rng.choice(np.arange(1, h), gy - 1, replace=False))
    xs = np.sort(rng.choice(np.arange(1, w), gx - 1, replace=False))
    iy = np.searchsorted(ys, np.arange(h), side="right")
    ix = np.searchsorted(xs, np.arange(w), side="right")
    sp = (iy[:, None] * gx + ix[None, :]).astype(np.int32)
    # a few stray pixels break the blocks, as SLIC maps do
    flip = rng.rand(h, w) < 0.02
    sp[flip] = rng.randint(0, s, flip.sum())
    return sp


def _jax_bits(key, n, s):
    avail = tseg.anchor_key_bits(s)
    return np.array(jax.random.randint(key, (n,), 0, 2 ** avail,
                                         dtype=jnp.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_anchors_equal_jax(seed):
    sp = _superpixels(seed)
    key = jax.random.key(seed + 10)
    want_yx, want_valid = jseg.sample_segment_anchors(jnp.asarray(sp), key,
                                                      10, S)
    got_yx, got_valid = tseg.sample_segment_anchors(
        torch.from_numpy(sp), 10, S,
        random_bits=torch.from_numpy(_jax_bits(key, sp.size, S)))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_yx.numpy(), np.asarray(want_yx))


def test_anchor_collisions_keep_pixel_order():
    """Equal composite keys (colliding random bits) must resolve by pixel
    index, as the JAX stable sort does."""
    sp = _superpixels(3)
    bits = np.zeros(sp.size, np.int32)  # every key collides in-segment
    yx, valid = tseg.sample_segment_anchors(torch.from_numpy(sp), 10, S,
                                            random_bits=torch.from_numpy(
                                                bits))
    flat = sp.reshape(-1)
    for s in range(S):
        first = np.flatnonzero(flat == s)[:10]
        got = (yx[s, :len(first), 0] * sp.shape[1]
               + yx[s, :len(first), 1]).numpy().astype(int)
        np.testing.assert_array_equal(got, first)
        assert valid[s].sum() == len(first)


def test_segment_reductions_match_jax():
    sp = _superpixels(4)
    ids = sp.reshape(-1)
    data = np.random.RandomState(0).rand(ids.size, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.segment_sizes(torch.from_numpy(ids), S + 2).numpy(),
        np.asarray(jseg.segment_sizes(jnp.asarray(ids), S + 2)))
    np.testing.assert_allclose(
        tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids),
                          S + 2).numpy(),
        np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                     S + 2)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tseg.center_of_mass(torch.from_numpy(sp), S + 2).numpy(),
        np.asarray(jseg.center_of_mass(jnp.asarray(sp), S + 2)))


@pytest.mark.parametrize("pos_scale", [1.0, 2.0])
def test_superpixel_align_matches_jax(pos_scale):
    b, hf, wf, c = 2, 10, 12, 16
    rng = np.random.RandomState(7)
    fmaps = rng.randn(b, hf, wf, c).astype(np.float32)
    sps = np.stack([_superpixels(10 + i) for i in range(b)])
    keys = jax.random.split(jax.random.key(5), b)
    want_f, want_v = [], []
    for i in range(b):
        f, v = jalign.superpixel_align(jnp.asarray(fmaps[i]),
                                       jnp.asarray(sps[i]), keys[i], 10, S,
                                       True, pos_scale)
        want_f.append(np.asarray(f))
        want_v.append(np.asarray(v))
    bits = np.stack([_jax_bits(keys[i], sps[i].size, S) for i in range(b)])
    got_f, got_v = talign.superpixel_align(
        torch.from_numpy(fmaps), torch.from_numpy(sps), 10, S,
        append_pos=True, pos_scale=pos_scale,
        random_bits=torch.from_numpy(bits))
    np.testing.assert_array_equal(got_v.numpy(), np.stack(want_v))
    np.testing.assert_allclose(got_f.numpy(), np.stack(want_f), rtol=0,
                               atol=1e-5)



@pytest.mark.parametrize("chunk", [1, 2])
def test_superpixel_align_chunks_equal_whole_batch(chunk, monkeypatch):
    """The gather and mean run over chunks of images; any chunk gives
    the whole batch's result (one chunk of B) bit for bit."""
    b, hf, wf, c = 3, 10, 12, 16
    rng = np.random.RandomState(9)
    fmaps = torch.from_numpy(rng.randn(b, hf, wf, c).astype(np.float32))
    sps = torch.from_numpy(np.stack([_superpixels(20 + i)
                                     for i in range(b)]))
    bits = torch.from_numpy(rng.randint(
        0, 2 ** tseg.anchor_key_bits(S), (b, sps[0].numel())).astype(
            np.int32))
    per_image = 8 * 4 * S * 10 * c  # align_chunk's bytes per image
    assert talign.align_chunk(S, 10, c) >= b
    whole_f, whole_v = talign.superpixel_align(fmaps, sps, 10, S,
                                               random_bits=bits)
    monkeypatch.setattr(talign, "ALIGN_CHUNK_BYTES", chunk * per_image)
    assert talign.align_chunk(S, 10, c) == chunk
    got_f, got_v = talign.superpixel_align(fmaps, sps, 10, S,
                                           random_bits=bits)
    np.testing.assert_array_equal(got_f.numpy(), whole_f.numpy())
    np.testing.assert_array_equal(got_v.numpy(), whole_v.numpy())


def test_align_chunk_fits_budget():
    # the default felzenszwalb unit: S = 1024, A = 10, C = 512
    n = talign.align_chunk(1024, 10, 512)
    assert n >= 1 and n * 8 * 4 * 1024 * 10 * 512 <= talign.ALIGN_CHUNK_BYTES
    assert talign.align_chunk(1 << 20, 10, 512) == 1

def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(8)
    fm = rng.randn(7, 9, 5).astype(np.float32)
    pts = np.stack([rng.uniform(0.5, 6.5, (4, 6)),
                    rng.uniform(0.5, 8.5, (4, 6))], -1).astype(np.float32)
    pts[0, 0] = [0.5, 0.5]  # exactly on cell centres and corners
    pts[0, 1] = [6.5, 8.5]
    np.testing.assert_allclose(
        talign.bilinear_sample(torch.from_numpy(fm),
                               torch.from_numpy(pts)).numpy(),
        np.asarray(jalign.bilinear_sample(jnp.asarray(fm),
                                          jnp.asarray(pts))),
        rtol=0, atol=1e-6)


def test_superpixel_prior_matches_jax():
    sps = np.stack([_superpixels(20), _superpixels(21)])
    want = np.stack([np.asarray(jprior.superpixel_prior(
        jnp.asarray(s), S + 1)) for s in sps])
    got = tprior.superpixel_prior(torch.from_numpy(sps), S + 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tprior.pixel_prior(40, 48,
                                                  device="cpu").numpy(),
                               np.asarray(jprior.pixel_prior(40, 48)),
                               rtol=1e-6, atol=0)


def test_pixel_prior_names_its_device():
    with pytest.raises(TypeError):
        tprior.pixel_prior(40, 48)


def _kmeans_inputs(seed, n=120, d=12, spread=1.2):
    """Three overlapping blobs (a few Lloyd sweeps to converge) plus a
    prior that favours the first, with padding rows."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, d) * spread
    lab = rng.randint(0, 3, n)
    X = (centers[lab] + rng.randn(n, d)).astype(np.float32)
    w = np.where(lab == 0, rng.uniform(0.5, 1, n),
                 rng.uniform(0, 0.5, n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-7:] = False
    return X, w, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_assignment_equals_jax(seed):
    X, w, valid = _kmeans_inputs(seed)
    key = jax.random.key(seed)
    want = np.asarray(jkm.kmeans_seed_assignment(jnp.asarray(w),
                                                 jnp.asarray(valid), 4, key))
    unif = np.array(jax.random.uniform(key, (w.size,)))
    got = tkm.kmeans_seed_assignment(torch.from_numpy(w),
                                     torch.from_numpy(valid), 4,
                                     uniforms=torch.from_numpy(unif))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_equals_jax_from_same_init(seed):
    X, w, valid = _kmeans_inputs(seed)
    a0 = np.array(jkm.kmeans_seed_assignment(
        jnp.asarray(w), jnp.asarray(valid), 4, jax.random.key(seed)))
    want = jkm.weighted_kmeans_from_init(jnp.asarray(X), jnp.asarray(w),
                                         jnp.asarray(valid),
                                         jnp.asarray(a0), k=4, n_iter=1000)
    got = tkm.weighted_kmeans_from_init(torch.from_numpy(X),
                                        torch.from_numpy(w),
                                        torch.from_numpy(valid),
                                        torch.from_numpy(a0), k=4,
                                        n_iter=1000)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    assert bool(got.empty_stop) == bool(want.empty_stop)
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=1e-5,
                               atol=1e-5)


def test_empty_cluster_stop_equals_jax():
    """Three far-apart blobs and k = 4: a cluster empties in the first
    sweep and the loop stops there, like the JAX loop."""
    X, w, valid = _kmeans_inputs(3, spread=8.0)
    a0 = np.array(jkm.kmeans_seed_assignment(
        jnp.asarray(w), jnp.asarray(valid), 4, jax.random.key(0)))
    want = jkm.weighted_kmeans_from_init(jnp.asarray(X), jnp.asarray(w),
                                         jnp.asarray(valid),
                                         jnp.asarray(a0), k=4, n_iter=50)
    got = tkm.weighted_kmeans_from_init(torch.from_numpy(X),
                                        torch.from_numpy(w),
                                        torch.from_numpy(valid),
                                        torch.from_numpy(a0), k=4,
                                        n_iter=50)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert bool(got.empty_stop) and bool(want.empty_stop)
    assert int(got.n_iter) == int(want.n_iter) == 1


@pytest.mark.parametrize("check_every", [1, 3, 16, 1000])
def test_grouped_loop_equals_per_group(check_every):
    """Groups stop on their own; a stopped group's carries stay frozen,
    so the batched loop equals separate runs, whatever the sync
    interval."""
    ins = [_kmeans_inputs(s) for s in (5, 6, 7)]
    X = torch.from_numpy(np.stack([i[0] for i in ins]))
    w = torch.from_numpy(np.stack([i[1] for i in ins]))
    valid = torch.from_numpy(np.stack([i[2] for i in ins]))
    unif = torch.from_numpy(np.random.RandomState(1).rand(3, X.shape[1])
                            .astype(np.float32))
    got = tkm.weighted_kmeans(X, w, valid, k=4, n_iter=1000, uniforms=unif,
                              check_every=check_every)
    iters = []
    for g in range(3):
        one = tkm.weighted_kmeans(X[g], w[g], valid[g], k=4, n_iter=1000,
                                  uniforms=unif[g])
        np.testing.assert_array_equal(got.assignment[g].numpy(),
                                      one.assignment.numpy())
        np.testing.assert_array_equal(got.centers[g].numpy(),
                                      one.centers.numpy())
        assert int(got.n_iter[g]) == int(one.n_iter)
        assert bool(got.converged[g]) == bool(one.converged)
        iters.append(int(one.n_iter))
    assert len(set(iters)) > 1  # the groups really stop at different sweeps


def _lloyd_unchunked(X, weights, valid, assign0, k, n_iter, check_every):
    """The Lloyd loop as one Python loop of sweeps with the check every
    ``check_every`` sweeps, written out op by op: the reference the
    chunked loop is held to."""
    X, weights, valid = X[None], weights[None], valid[None]
    assign = assign0[None].to(torch.int32)
    w_other = 1.0 - weights
    centers = tkm._cluster_means(X, assign, valid.to(torch.float32), k)
    x2 = (X * X).sum(-1, keepdim=True)
    it = torch.zeros(1, dtype=torch.int32)
    done = torch.zeros(1, dtype=torch.bool)
    converged, empty_stop = torch.zeros_like(done), torch.zeros_like(done)
    for t in range(n_iter):
        if t and t % check_every == 0 and bool(done.all()):
            break
        new_assign = tkm._assign_step(X, x2, centers, valid)
        same = (new_assign == assign).all(-1)
        eff_w = torch.where(valid, torch.where(new_assign == 0, weights,
                                               w_other), 0.0)
        new_centers = tkm._cluster_means(X, new_assign, eff_w, k)
        any_empty = ((new_assign[..., None] == torch.arange(k)).sum(1)
                     == 0).any(-1)
        active = ~done
        centers = torch.where((active & ~same)[:, None, None], new_centers,
                              centers)
        assign = torch.where(active[:, None], new_assign, assign)
        it = it + active.to(torch.int32)
        converged = torch.where(active, same, converged)
        empty_stop = torch.where(active, any_empty & ~same, empty_stop)
        done = done | (active & (same | any_empty))
    return assign[0], centers[0], it[0], converged[0], empty_stop[0]


@pytest.mark.parametrize("seed,spread,n_iter,check_every", [
    (0, 1.2, 1000, 1), (1, 1.2, 1000, 3), (2, 1.2, 1000, 16),
    (3, 8.0, 50, 16), (4, 0.3, 7, 4), (5, 0.3, 1000, 1000)])
def test_cpu_loop_runs_eager_chunks_equal_to_the_unchunked_loop(
        seed, spread, n_iter, check_every):
    """On CPU tensors the loop runs its chunks sweep by sweep: it counts
    each chunk and no replay, and its results equal the unchunked loop's
    bit for bit (``n_iter = 7`` with chunks of 4: a shorter last
    chunk)."""
    X, w, valid = (torch.from_numpy(a) for a in _kmeans_inputs(
        seed, spread=spread))
    a0 = tkm.kmeans_seed_assignment(w, valid, 4,
                                    generator=torch.Generator().manual_seed(
                                        seed))
    before = timers.counts()
    got = tkm.weighted_kmeans_from_init(X, w, valid, a0, k=4,
                                        n_iter=n_iter,
                                        check_every=check_every)
    after = timers.counts()
    want = _lloyd_unchunked(X, w, valid, a0, 4, n_iter, check_every)
    for g, v in zip(got, want):  # an emptied cluster's centre is NaN
        torch.testing.assert_close(g, v, rtol=0, atol=0, equal_nan=True)
    chunks = -(-int(got.n_iter) // check_every)
    assert (after["kmeans.chunks"] - before.get("kmeans.chunks", 0)
            == chunks)
    assert after.get("kmeans.replays", 0) == before.get("kmeans.replays", 0)


def test_paint_and_pack_equal_jax():
    rng = np.random.RandomState(9)
    sps = np.stack([_superpixels(30), _superpixels(31)])
    assign = rng.randint(0, 4, (2, S)).astype(np.int32)
    want = np.asarray(jkm.paint_clusters(jnp.asarray(sps),
                                         jnp.asarray(assign), max_id=4))
    got = tkm.paint_clusters(torch.from_numpy(sps),
                             torch.from_numpy(assign)).numpy()
    np.testing.assert_array_equal(got, want)
    for w in (48, 45):  # a width that is not a multiple of 8 pads
        road = rng.rand(3, 5, w) < 0.5
        packed = pack_mask_bits(torch.from_numpy(road)).numpy()
        np.testing.assert_array_equal(packed,
                                      np.asarray(jpack(jnp.asarray(road))))
        np.testing.assert_array_equal(unpack_mask_bits(packed, w), road)
