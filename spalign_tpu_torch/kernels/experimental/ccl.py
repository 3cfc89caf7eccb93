"""Connected-component labelling + small-fragment absorption on the
device, in plain torch (counterpart of
``spalign_tpu/kernels/experimental/ccl.py``, which is jnp, not Pallas).

The connectivity post-pass of SLIC (split non-contiguous label regions,
absorb fragments below min_size) runs as union-find on the host
(``native.enforce_connectivity``).  This keeps it on the device, with
the JAX function's steps and statics:

  1. connected components by min-index propagation: every pixel starts
     as its own component (its flat index); ``n_iter`` sweeps of
     {4-neighbour min within the same input label} + {pointer jumping
     comp <- comp[comp], twice};
  2. compact ids by a stable argsort of the roots (rank of first
     occurrence);
  3. fragment absorption (``n_absorb`` sweeps when min_size > 1):
     components smaller than min_size adopt the smallest-id adjacent
     component of at least min_size pixels;
  4. a final contiguous relabel.

Ids at or above ``max_components`` behave as in JAX: segment sums and
minima drop them and gathers clamp them to the table (ids are never
negative).  Every step is
integer arithmetic, so the card and the CPU give the same maps.
Absorption picks the lowest-id neighbour where the host op picks
another, so partitions with fragments can differ from the host op's.
"""

from __future__ import annotations

import torch

BIG = 2 ** 30
_INT32_MAX = 2 ** 31 - 1


def _shifted(x: torch.Tensor, fill: int):
    """x's four neighbours (the pixel below, above, right, left of each),
    ``fill`` past the border."""
    below = torch.full_like(x, fill)
    below[..., :-1, :] = x[..., 1:, :]
    above = torch.full_like(x, fill)
    above[..., 1:, :] = x[..., :-1, :]
    right = torch.full_like(x, fill)
    right[..., :, :-1] = x[..., :, 1:]
    left = torch.full_like(x, fill)
    left[..., :, 1:] = x[..., :, :-1]
    return below, above, right, left


def _neighbor_min(comp: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """Min component id over each pixel and its 4-neighbours of the same
    input label."""
    out = comp
    for c_sh, l_sh in zip(_shifted(comp, BIG), _shifted(lab, -1)):
        out = torch.minimum(out, torch.where(l_sh == lab, c_sh, BIG))
    return out


def _components(lab: torch.Tensor, n_iter: int) -> torch.Tensor:
    """(B, H, W) labels -> (B, H*W) component roots (flat pixel ids)."""
    b, h, w = lab.shape
    comp = torch.arange(h * w, dtype=torch.int64,
                        device=lab.device).reshape(1, h, w).repeat(b, 1, 1)
    for _ in range(n_iter):
        flat = _neighbor_min(comp, lab).reshape(b, -1)
        flat = torch.minimum(flat, flat.gather(1, flat))  # pointer jump
        flat = torch.minimum(flat, flat.gather(1, flat))
        comp = flat.reshape(b, h, w)
    return comp.reshape(b, -1)


def _compact_ids(roots: torch.Tensor) -> torch.Tensor:
    """(B, N) root values -> contiguous ids ordered by root value."""
    order = torch.argsort(roots, dim=1, stable=True)
    sorted_roots = roots.gather(1, order)
    first = torch.ones_like(roots)
    first[:, 1:] = (sorted_roots[:, 1:] != sorted_roots[:, :-1]).to(
        roots.dtype)
    ranks = torch.cumsum(first, 1) - 1
    return torch.empty_like(roots).scatter_(1, order, ranks)


def _segment_reduce(values: torch.Tensor, ids: torch.Tensor, m: int,
                    reduce: str, init: int) -> torch.Tensor:
    """(B, N) ids >= 0 reduce values into (B, m); ids >= m are dropped,
    empty segments hold ``init``."""
    out = torch.full((ids.shape[0], m + 1), init, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(1, ids.clamp(max=m), values, reduce,
                        include_self=True)
    return out[:, :m]


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] row by row, ids >= 0 clamped to the table as JAX's
    gather clamps them."""
    return table.gather(1, ids.clamp(max=table.shape[1] - 1))


def enforce_connectivity_device(labels: torch.Tensor, min_size: int = 1,
                                n_iter: int = 16, n_absorb: int = 3,
                                max_components: int = 1 << 15
                                ) -> torch.Tensor:
    """(B, H, W) or (H, W) integer label maps -> connectivity-enforced,
    min_size-absorbed, contiguous (per image) int32 label maps, on the
    labels' device."""
    single = labels.dim() == 2
    lab = (labels[None] if single else labels).to(torch.int64)
    b, h, w = lab.shape
    m = max_components
    ids = _compact_ids(_components(lab, n_iter))
    for _ in range(n_absorb if min_size > 1 else 0):
        sizes = _segment_reduce(torch.ones_like(ids), ids, m, "sum", 0)
        size2d = _take(sizes, ids).reshape(b, h, w)
        id2d = ids.reshape(b, h, w)
        cand = torch.full_like(id2d, BIG)
        for c_sh, s_sh in zip(_shifted(id2d, BIG), _shifted(size2d, 0)):
            cand = torch.minimum(cand, torch.where(s_sh >= min_size, c_sh,
                                                   BIG))
        comp_cand = _segment_reduce(cand.reshape(b, -1), ids, m, "amin",
                                    _INT32_MAX)
        adopt = (sizes < min_size) & (comp_cand < BIG)
        new_of = torch.where(adopt, comp_cand,
                             torch.arange(m, device=ids.device))
        ids = _take(new_of, ids)
    out = _compact_ids(ids).reshape(b, h, w).to(torch.int32)
    return out[0] if single else out
