"""SSSP with path reconstruction (``apps/src/sssp_path.gm``).

The compound argmin assignment ``<s.dist_nxt; s.updated_nxt, s.prev> min=
<n.dist + e.len; True, n>`` carries the winning predecessor alongside the
distance.  Device formulation: two sorted-segment passes per superstep —
first the min distance, then the smallest source achieving it (the
reference's atomic argmin keeps an arbitrary winner under races,
``gm_cpp_gen.cc:1563-1742``; normalized to min-id, documented).

``get_path`` mirrors the sequential path-walk procedure (get_path in
sssp_path.gm:33-42) on host.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops


class SsspPathResult(NamedTuple):
    dist: jax.Array        # [N_pad] int32
    prev: jax.Array        # [N_pad] int32 predecessor, -1 = NIL
    prev_edge: jax.Array   # [N_pad] int32 CSR slot of the prev edge, -1
    iterations: jax.Array


@partial(jax.jit, static_argnames=("max_iter",))
def sssp_path(g: Graph, root, edge_len: jax.Array,
              max_iter: int | None = None) -> SsspPathResult:
    if max_iter is None:
        max_iter = g.num_nodes + 1
    inf = jnp.iinfo(jnp.int32).max
    NIL = jnp.int32(-1)
    ids = jnp.arange(g.n_pad, dtype=jnp.int32)
    dist0 = jnp.where((ids == root) & g.node_mask(), 0, inf)
    upd0 = (ids == root) & g.node_mask()
    w_csc = edge_len[g.e_rev2idx].astype(jnp.int32)
    src = g.r_node_idx
    dstseg = g.r_node_idx_dst

    def step(state):
        dist, upd, prev, pedge = state
        cand = jnp.where(upd[src], dist[src] + w_csc, inf)
        best = ops.sorted_segment_reduce(cand, dstseg, g.r_begin,
                                         g.n_pad, "min")
        improved = best < dist
        new_dist = jnp.minimum(dist, best)
        # second pass: smallest source id that achieved the winning value
        win = cand == best[dstseg]
        psrc = jnp.where(win, src.astype(jnp.int32), inf)
        arg = ops.sorted_segment_reduce(psrc, dstseg, g.r_begin,
                                        g.n_pad, "min")
        # and its CSR edge slot (for prev_edge): smallest slot among
        # winners with that source
        pslot = jnp.where(win & (src.astype(jnp.int32) == arg[dstseg]),
                          g.e_rev2idx.astype(jnp.int32), inf)
        argslot = ops.sorted_segment_reduce(pslot, dstseg, g.r_begin,
                                            g.n_pad, "min")
        prev = jnp.where(improved, arg, prev)
        pedge = jnp.where(improved, argslot, pedge)
        return new_dist, improved, prev, pedge

    def not_done(state):
        return jnp.any(state[1])

    state0 = (dist0, upd0, jnp.full((g.n_pad,), NIL),
              jnp.full((g.n_pad,), NIL))
    (dist, _, prev, pedge), stats = while_loop(step, not_done, state0,
                                               max_iter)
    return SsspPathResult(dist=dist, prev=prev, prev_edge=pedge,
                          iterations=stats.iterations)


def get_path(prev: np.ndarray, begin_node: int, end_node: int) -> list:
    """Host path walk (sssp_path.gm get_path): node sequence begin..end,
    or [] when unreachable."""
    prev = np.asarray(prev)
    if end_node != begin_node and prev[end_node] < 0:
        return []
    out = [end_node]
    t = end_node
    while t != begin_node:
        t = int(prev[t])
        if t < 0:
            return []
        out.append(t)
    return out[::-1]
