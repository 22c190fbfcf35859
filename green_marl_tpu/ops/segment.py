"""Edge-map / segment-reduction kernel library (pure-XLA reference path).

These primitives replace the reference's generated OpenMP foreach loops and
atomic reductions (``src/backend_cpp/gm_cpp_gen.cc:1021-1072,1526-1561``,
``gm_cpp_gen_foreach.cc:33-328``): instead of per-thread loops over CSR
ranges with CAS/lock reductions, every neighborhood operation is expressed
as a dense gather over the padded edge arrays followed by a segment
reduction over sorted slots.  Race-freedom is by construction
(the RW-analysis race oracle of ``src/frontend/gm_rw_analysis.cc`` is not
needed at runtime).

Convention: "pull" ops iterate CSC slots (``r_node_idx`` = sources, sorted
by destination — equivalent of ``t.InNbrs``), "push" ops iterate CSR slots
(``node_idx`` = destinations, sorted by source — ``n.Nbrs``).  Padded slots
carry sentinel endpoints that route junk into the property junk row
(see ``graph.csr``), so no masking is needed for reductions whose identity
is safe; ops that need masking do it explicitly.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..graph.csr import Graph


# ---------------------------------------------------------------------------
# Raw segment reductions.  Integer sums and min/max are exact in any
# order; float sums take XLA's scatter-add order, which on a GPU is
# atomic and varies from run to run in the last bits
# (doc/known_issues.md).
# ---------------------------------------------------------------------------

def _seg(op, vals, ids, num_segments, sorted_ids):
    return op(vals, ids, num_segments=num_segments,
              indices_are_sorted=sorted_ids)


def sorted_segment_reduce(vals: jax.Array, ids: jax.Array,
                          offsets: jax.Array, n_out: int,
                          op: str) -> jax.Array:
    """Segment reduction over *sorted* runs described by ``offsets``.

    ``jax.ops.segment_*`` with ``indices_are_sorted=True``; ``ids`` is
    the per-slot segment id (pad slots carry a sentinel id whose output
    row the caller ignores).  ``offsets`` [S+1] states the runs of
    ``ids``; this implementation reads ``ids`` alone.
    """
    fn = {"add": jax.ops.segment_sum, "min": jax.ops.segment_min,
          "max": jax.ops.segment_max}[op]
    return _seg(fn, vals, ids, n_out, True)


def sorted_segment_or(words: jax.Array, ids: jax.Array,
                      num_segments: int) -> jax.Array:
    """Bitwise-OR segment reduction over SORTED segment ids.

    ``words`` [E] or [E, W] integer words (bit-packed instance planes,
    ``ops.binned``'s convention); ``ids`` [E] ascending.  Returns
    ``[num_segments(, W)]``; empty segments get 0.

    ``jax.ops`` has no segment_or, and OR over multi-bit words is not
    expressible as min/max — this uses the classic segmented inclusive
    scan (flag-reset combine, associative) via ``lax.associative_scan``
    plus one gather at each segment's last slot.  Replaces the
    reference's per-thread ``|=`` CAS loops the same way the other
    reductions replace its atomics (``gm_cpp_gen.cc:1526-1561``).
    """
    E = words.shape[0]

    def bcast(flag, like):
        return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))

    first = jnp.concatenate(
        [jnp.ones((1,), bool), ids[1:] != ids[:-1]])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(bcast(fb, vb), vb, va | vb)

    _, scanned = jax.lax.associative_scan(comb, (first, words))
    off = jnp.searchsorted(ids, jnp.arange(num_segments + 1,
                                           dtype=ids.dtype))
    last = jnp.clip(off[1:] - 1, 0, E - 1)
    out = scanned[last]
    nonempty = off[1:] > off[:-1]
    return jnp.where(bcast(nonempty, out), out,
                     jnp.zeros((), words.dtype))


def segment_sum(vals, ids, num_segments, sorted_ids=False):
    return _seg(jax.ops.segment_sum, vals, ids, num_segments, sorted_ids)


def segment_min(vals, ids, num_segments, sorted_ids=False):
    return _seg(jax.ops.segment_min, vals, ids, num_segments, sorted_ids)


def segment_max(vals, ids, num_segments, sorted_ids=False):
    return _seg(jax.ops.segment_max, vals, ids, num_segments, sorted_ids)


# ---------------------------------------------------------------------------
# Pull (in-neighbor) reductions: out[v] = reduce_{(w -> v) in E} f(w, e)
# ---------------------------------------------------------------------------

def pull_edge_values(g: Graph, node_vals: jax.Array,
                     edge_vals: Optional[jax.Array] = None,
                     combine: Optional[Callable] = None) -> jax.Array:
    """[E_pad] per-CSC-slot values: node_vals gathered at the source
    endpoint, optionally combined with an edge property (CSR slot order,
    permuted through ``e_rev2idx`` — reference ``e_rev2idx`` usage in
    ``gm_graph.cc:205-296``)."""
    x = node_vals[g.r_node_idx]
    if edge_vals is not None:
        w = edge_vals[g.e_rev2idx]
        x = combine(x, w) if combine else x * w
    return x


def in_nbr_sum(g: Graph, node_vals: jax.Array,
               edge_vals: Optional[jax.Array] = None,
               combine: Optional[Callable] = None) -> jax.Array:
    """``Sum(w: t.InNbrs){ f(w) }`` for every t (e.g. pagerank.gm:12)."""
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "add")


def in_nbr_min(g: Graph, node_vals, edge_vals=None, combine=None):
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "min")


def in_nbr_max(g: Graph, node_vals, edge_vals=None, combine=None):
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "max")


def in_nbr_any(g: Graph, node_mask: jax.Array) -> jax.Array:
    """out[v] = Exist(w: v.InNbrs){ node_mask[w] } (bool)."""
    vals = node_mask[g.r_node_idx].astype(jnp.int32)
    return segment_max(vals, g.r_node_idx_dst, g.n_pad, sorted_ids=True) > 0


# ---------------------------------------------------------------------------
# Push (out-neighbor) reductions: out[v] = reduce_{(v -> s) in E} f(...)
# ---------------------------------------------------------------------------

def push_edge_values(g: Graph, node_vals: jax.Array,
                     edge_vals: Optional[jax.Array] = None,
                     combine: Optional[Callable] = None) -> jax.Array:
    """[E_pad] per-CSR-slot values gathered at the source endpoint."""
    x = node_vals[g.node_idx_src]
    if edge_vals is not None:
        x = combine(x, edge_vals) if combine else x * edge_vals
    return x


def out_nbr_sum(g: Graph, node_vals, edge_vals=None, combine=None):
    """out[v] = Sum(s: v.Nbrs){ node_vals[s] } — gather at the *destination*
    endpoint, reduce by source (CSR ids are sorted)."""
    x = node_vals[g.node_idx]
    if edge_vals is not None:
        x = combine(x, edge_vals) if combine else x * edge_vals
    return sorted_segment_reduce(x, g.node_idx_src, g.begin, g.n_pad, "add")


def out_nbr_min(g: Graph, node_vals, edge_vals=None, combine=None):
    x = node_vals[g.node_idx]
    if edge_vals is not None:
        x = combine(x, edge_vals) if combine else x * edge_vals
    return sorted_segment_reduce(x, g.node_idx_src, g.begin, g.n_pad, "min")


def scatter_min_to_dst(g: Graph, edge_vals_csr: jax.Array) -> jax.Array:
    """Push-style ``s.prop min= value`` over CSR slots: unsorted scatter-min
    keyed by destination (reference atomic argmin path,
    ``gm_cpp_gen.cc:1563-1742``)."""
    return segment_min(edge_vals_csr, g.node_idx, g.n_pad, sorted_ids=False)


def scatter_sum_to_dst(g: Graph, edge_vals_csr: jax.Array) -> jax.Array:
    return segment_sum(edge_vals_csr, g.node_idx, g.n_pad, sorted_ids=False)


# ---------------------------------------------------------------------------
# Whole-graph reductions over node properties
# ---------------------------------------------------------------------------

def masked_node_sum(g: Graph, vals: jax.Array, where=None):
    mask = g.node_mask()
    if where is not None:
        mask = mask & where
    return jnp.sum(jnp.where(mask, vals, jnp.zeros((), vals.dtype)))

def masked_node_max(g: Graph, vals: jax.Array, init, where=None):
    mask = g.node_mask()
    if where is not None:
        mask = mask & where
    return jnp.max(jnp.where(mask, vals, jnp.full((), init, vals.dtype)))

def masked_node_min(g: Graph, vals: jax.Array, init, where=None):
    mask = g.node_mask()
    if where is not None:
        mask = mask & where
    return jnp.min(jnp.where(mask, vals, jnp.full((), init, vals.dtype)))

def node_any(g: Graph, mask_vals: jax.Array) -> jax.Array:
    """``Exist(n: G.Nodes){ p(n) }``."""
    return jnp.any(mask_vals & g.node_mask())


# ---------------------------------------------------------------------------
# Neighborhood membership (semi-sorted rows -> binary search)
# ---------------------------------------------------------------------------

def has_edge_to(g: Graph, src: jax.Array, dst: jax.Array) -> jax.Array:
    """Vectorized ``HasEdgeTo`` builtin (reference binary-search
    ``is_neighbor`` over semi-sorted rows, ``gm_graph.h``/``do_semi_sort``
    ``gm_graph.cc:468``).

    src/dst: equal-shaped int arrays of node ids; returns bool array.
    Each query binary-searches row ``src`` of the CSR for ``dst``.
    """
    lo = g.begin[src]
    hi = g.begin[src + 1]
    # Binary search over the full node_idx with per-query [lo, hi) bounds.
    # ceil(log2(max_degree)) iterations; max degree <= num_nodes.
    bits = max(1, int(g.num_nodes).bit_length())

    def body(_, state):
        lo, hi = state
        active = lo < hi
        mid = (lo + hi) // 2
        v = g.node_idx[jnp.clip(mid, 0, g.e_pad - 1)]
        go_right = active & (v < dst)
        new_lo = jnp.where(go_right, mid + 1, lo)
        new_hi = jnp.where(active & ~go_right, mid, hi)
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, bits + 1, body, (lo, hi))
    found = (lo < g.begin[src + 1]) & \
        (g.node_idx[jnp.clip(lo, 0, g.e_pad - 1)] == dst)
    return found
