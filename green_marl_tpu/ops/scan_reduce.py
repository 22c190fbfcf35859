"""Scatter-free sorted-segment sums via prefix sums.

Our CSC/CSR slot arrays are sorted by segment (destination resp.
source), so every segment is a contiguous run ``[begin[v], begin[v+1])``
and a segment sum is expressible with dense primitives and no scatter:

    c = exclusive_cumsum(vals)            # one pass over E
    out[v] = c[begin[v+1]] - c[begin[v]]  # two gathers over N

This module provides that path for **invertible** ops (integer/bool sums,
counts, OR/ANY via sum>0).  It is *exact* for integers: the prefix wraps
modulo 2^32 and the differences unwrap it.  For float32 sums the global
prefix magnitude would swamp small addends, so float sums and min/max
reductions stay on ``ops.segment.sorted_segment_reduce``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..graph.csr import Graph


def segment_sum_by_offsets(vals: jax.Array, offsets: jax.Array,
                           n_out: int) -> jax.Array:
    """Sum of sorted-run segments: ``out[v] = sum(vals[offsets[v]:offsets[v+1]])``.

    ``vals``: [E_pad] — entries beyond ``offsets[-1]`` are ignored (the
    prefix is only ever evaluated at offsets).  Exact for integer dtypes;
    float sums belong on ``ops.segment.sorted_segment_reduce``.
    """
    c = jnp.cumsum(vals)
    ex = jnp.concatenate([jnp.zeros((1,), c.dtype), c])  # exclusive prefix
    lo = ex[offsets[:-1]]
    hi = ex[offsets[1:]]
    out = hi - lo
    pad = n_out - out.shape[0]
    if pad:
        out = jnp.pad(out, (0, pad))
    return out


def in_nbr_count_true(g: Graph, node_mask_vals: jax.Array) -> jax.Array:
    """[N_pad] int32 — per node, number of in-neighbors w with
    ``node_mask_vals[w]`` true.  Exact (integer cumsum)."""
    vals = node_mask_vals[g.r_node_idx].astype(jnp.int32)
    return segment_sum_by_offsets(vals, g.r_begin, g.n_pad)


def in_nbr_any_fast(g: Graph, node_mask_vals: jax.Array) -> jax.Array:
    """Scatter-free ``Exist(w: v.InNbrs){ mask[w] }``: OR as sum>0."""
    return in_nbr_count_true(g, node_mask_vals) > 0


def out_nbr_count_true(g: Graph, node_mask_vals: jax.Array) -> jax.Array:
    vals = node_mask_vals[g.node_idx].astype(jnp.int32)
    return segment_sum_by_offsets(vals, g.begin, g.n_pad)


def out_nbr_any_fast(g: Graph, node_mask_vals: jax.Array) -> jax.Array:
    return out_nbr_count_true(g, node_mask_vals) > 0


def in_nbr_sum_int(g: Graph, node_vals: jax.Array,
                   edge_vals: Optional[jax.Array] = None) -> jax.Array:
    """Exact integer pull-sum over in-edges (int32/int64 vals)."""
    x = node_vals[g.r_node_idx]
    if edge_vals is not None:
        x = x * edge_vals[g.e_rev2idx]
    return segment_sum_by_offsets(x, g.r_begin, g.n_pad)
