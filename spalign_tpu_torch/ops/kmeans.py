"""Prior-seeded weighted k-means (Lloyd), batched over clustering groups.

Counterpart of ``spalign_tpu/ops/kmeans.py`` (reference
batch_spalign_kmeans.py:136-207):

  * seeding: rows whose prior weight exceeds the median go to cluster 0
    (the road cluster); the rest get round-robin labels 1..k-1 in a
    uniformly random order;
  * initial centres: unweighted per-cluster means;
  * Lloyd updates: cluster 0's centre is the prior-weighted mean of its
    members, clusters 1..k-1 use (1 - prior) weights;
  * stop on a stable assignment, on an empty cluster, or after n_iter
    sweeps.

Every function takes a leading group axis G (``X`` (G, N, D)) or none
(``X`` (N, D)).  Each group stops on its own: a group that has stopped
keeps its carries frozen while the others go on, which is what the JAX
package's vmapped ``while_loop`` does.  The host checks whether every
group has stopped only every ``check_every`` sweeps (one device sync
each, a ``kmeans.check`` span); the results do not depend on it.  On
CUDA tensors each chunk of ``check_every`` sweeps is one replay of a
CUDA graph (``utils/graphs.py``), so the chunk costs the host one launch
instead of ~41 a sweep.  Padded rows (``valid`` False) carry weight 0 and assignment -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spalign_tpu_torch.utils.graphs import GraphCache
from spalign_tpu_torch.utils.timers import count, span


class KMeansResult(NamedTuple):
    assignment: torch.Tensor  # (G, N) int32, -1 for invalid rows
    centers: torch.Tensor  # (G, k, D) float32
    n_iter: torch.Tensor  # (G,) int32 Lloyd sweeps executed
    converged: torch.Tensor  # (G,) bool stable assignment reached
    empty_stop: torch.Tensor  # (G,) bool stopped on an empty cluster


def _grouped(*tensors):
    """Add the group axis to ungrouped inputs; returns (tensors, added)."""
    added = tensors[0].dim() == 1
    return [t[None] if added else t for t in tensors], added


def _median_threshold(weights: torch.Tensor, valid: torch.Tensor):
    """sort(weights over valid rows)[n_valid // 2] per group (reference
    :144); invalid rows sort to +inf."""
    n_valid = valid.sum(-1)
    w_sorted = torch.sort(torch.where(valid, weights, float("inf")),
                          dim=-1).values
    return w_sorted.gather(-1, (n_valid // 2)[..., None])[..., 0]


def kmeans_seed_assignment(weights: torch.Tensor, valid: torch.Tensor,
                           k: int, uniforms: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Initial assignment (reference :141-149), (G, N) or (N,).

    Cluster 0 <- weight > median; the other valid rows are ranked by a
    stable argsort of ``uniforms`` (drawn from ``generator`` in [0, 1)
    when absent) and labelled ``rank % (k-1) + 1``.  Invalid rows get -1.
    """
    (weights, valid), added = _grouped(weights, valid)
    thr = _median_threshold(weights, valid)
    lo = valid & (weights <= thr[..., None])
    if uniforms is None:
        uniforms = torch.rand(weights.shape, generator=generator,
                              device=weights.device)
    elif added:
        uniforms = uniforms[None]
    order = torch.argsort(torch.where(lo, uniforms, float("inf")), dim=-1,
                          stable=True)
    n = weights.shape[-1]
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(n, device=order.device).expand_as(
        order).contiguous())
    rr_label = rank % (k - 1) + 1
    assign = torch.where(lo, rr_label, 0)
    assign = torch.where(valid, assign, -1).to(torch.int32)
    return assign[0] if added else assign


def _cluster_means(X, assign, row_weights, k):
    """(G, k, D) weighted per-cluster means; assign == -1 excluded.
    Non-finite for an empty cluster, as in the reference."""
    onehot = (assign[..., None] == torch.arange(k, device=X.device)).to(
        X.dtype)
    wo = onehot * row_weights[..., None]  # (G, N, k)
    sums = torch.bmm(wo.transpose(1, 2), X)
    return sums / wo.sum(1)[..., None]


def _assign_step(X, x2, centers, valid):
    """argmin_k ||x - c_k||^2 as x2 - 2 x.c + c2; invalid rows -> -1."""
    c2 = (centers * centers).sum(-1)[:, None, :]  # (G, 1, k)
    d2 = x2 - 2.0 * torch.bmm(X, centers.transpose(1, 2)) + c2
    new_assign = d2.argmin(-1).to(torch.int32)
    return torch.where(valid, new_assign, -1)


def weighted_kmeans(X: torch.Tensor, weights: torch.Tensor,
                    valid: torch.Tensor, k: int = 4, n_iter: int = 1000,
                    uniforms: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    check_every: int = 16) -> KMeansResult:
    """Prior-seeded weighted k-means: seeding, then the Lloyd loop."""
    assign0 = kmeans_seed_assignment(weights, valid, k, uniforms=uniforms,
                                     generator=generator)
    return weighted_kmeans_from_init(X, weights, valid, assign0, k=k,
                                     n_iter=n_iter, check_every=check_every)


def weighted_kmeans_from_init(X: torch.Tensor, weights: torch.Tensor,
                              valid: torch.Tensor, assign0: torch.Tensor,
                              k: int = 4, n_iter: int = 1000,
                              check_every: int = 16) -> KMeansResult:
    """The Lloyd loop from an explicit initial assignment:
    ``lloyd_start``, then ``lloyd_loop``."""
    (weights, valid, assign0), added = _grouped(weights, valid, assign0)
    if added:
        X = X[None]
    res = lloyd_loop(*lloyd_start(X, weights, valid, assign0, k),
                     n_iter=n_iter, check_every=check_every)
    return KMeansResult(*(r[0] for r in res)) if added else res


def lloyd_start(X: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor,
                assign0: torch.Tensor, k: int):
    """The Lloyd loop's inputs (X, x2, weights, 1 - weights, valid,
    arange(k)) and initial carries (assign, centers, it, done, converged,
    empty_stop) of grouped (G, N, D) ``X``: device work only, so it can
    be captured."""
    X = X.to(torch.float32).contiguous()
    weights = weights.to(torch.float32)
    dev = X.device
    g = X.shape[0]
    x2 = (X * X).sum(-1, keepdim=True)  # loop-invariant
    inputs = (X, x2, weights, 1.0 - weights, valid,
              torch.arange(k, device=dev))
    done = torch.zeros(g, dtype=torch.bool, device=dev)
    carries = (assign0.to(torch.int32),
               _cluster_means(X, assign0, valid.to(torch.float32), k),
               torch.zeros(g, dtype=torch.int32, device=dev), done,
               torch.zeros_like(done), torch.zeros_like(done))
    return inputs, carries


def lloyd_loop(inputs, carries, n_iter: int = 1000,
               check_every: int = 16) -> KMeansResult:
    """The Lloyd loop of ``lloyd_start``'s inputs and carries, in chunks
    of ``check_every`` sweeps with the host's check between two chunks.
    On CUDA tensors a whole chunk is one replay of a CUDA graph of the
    chunk's sweeps (``_chunk_graph``); a shorter last chunk and CPU
    tensors run the sweeps one by one.  Counters: ``kmeans.chunks`` for
    every chunk, ``kmeans.replays`` for the chunks a graph ran.  The
    result shares no memory with ``carries`` or a graph."""
    if check_every < 1:
        raise ValueError(f"check_every={check_every} must be >= 1")
    graph = None
    t = 0
    while t < n_iter:
        if t:
            with span("kmeans.check"):
                stop = bool(carries[3].all())
            if stop:
                break
        m = min(check_every, n_iter - t)
        count("kmeans.chunks")
        if inputs[0].is_cuda and m == check_every:
            if graph is None:
                graph = _chunk_graph(inputs, carries, m)
            graph.replay(0)
            carries = graph.bufs["carries"]
            count("kmeans.replays")
        else:
            for _ in range(m):
                carries = _sweep(inputs, carries)
        t += m
    if graph is not None or t == 0:  # the next call's replays rewrite
        carries = tuple(c.clone() for c in carries)  # a graph's buffers
    return KMeansResult(*carries[:3], *carries[4:])


def _sweep(inputs, carries):
    """One Lloyd sweep of every group: the new carries (assign, centers,
    it, done, converged, empty_stop) from the loop's inputs (X, x2,
    weights, 1 - weights, valid, arange(k)).  A group that has stopped
    keeps its carries."""
    X, x2, weights, w_other, valid, ks = inputs
    assign, centers, it, done, converged, empty_stop = carries
    new_assign = _assign_step(X, x2, centers, valid)
    same = (new_assign == assign).all(-1)
    eff_w = torch.where(new_assign == 0, weights, w_other)
    eff_w = torch.where(valid, eff_w, 0.0)
    new_centers = _cluster_means(X, new_assign, eff_w, len(ks))
    counts = (new_assign[..., None] == ks).sum(1)  # (G, k)
    any_empty = (counts == 0).any(-1)
    active = ~done
    # on `same` the reference breaks before updating the centres
    centers = torch.where((active & ~same)[:, None, None], new_centers,
                          centers)
    assign = torch.where(active[:, None], new_assign, assign)
    it = it + active.to(torch.int32)
    converged = torch.where(active, same, converged)
    empty_stop = torch.where(active, any_empty & ~same, empty_stop)
    done = done | (active & (same | any_empty))
    return assign, centers, it, done, converged, empty_stop


def _chunk_graph(inputs, carries, length: int):
    """The CUDA graph of ``length`` sweeps (one a device, shape, k, length
    and dtypes; the newest 8 kept), holding these inputs and carries; a
    replay leaves the chunk's carries in its ``carries`` buffers."""
    def chunk(b):
        out = b["carries"]
        for _ in range(length):
            out = _sweep(b["inputs"], out)
        for dst, src in zip(b["carries"], out):
            dst.copy_(src)
        return {}

    X, _, _, _, valid, ks = inputs
    key = (X.device, *X.shape, len(ks), length, X.dtype, valid.dtype,
           carries[0].dtype)
    return _GRAPHS.load(key, (chunk,), {"inputs": inputs, "carries": carries})


_GRAPHS = GraphCache(8, counted=())


def paint_clusters(superpixels: torch.Tensor,
                   assignment: torch.Tensor) -> torch.Tensor:
    """(B, H, W) superpixel maps + (B, S) cluster id per superpixel ->
    (B, H, W) int32 cluster maps (reference :191-199), by a gather, which
    is exact.  Road mask = (map == 0)."""
    b = superpixels.shape[0]
    flat = superpixels.reshape(b, -1).to(torch.int64)
    return assignment.gather(1, flat).reshape(superpixels.shape).to(
        torch.int32)
