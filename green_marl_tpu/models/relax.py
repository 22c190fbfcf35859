"""Generic masked min-relaxation engine (the <prop; flag> min= pattern).

Green-Marl's BFS/SSSP family all reduce to the same superstep (hop_dist.gm
:36-50, sssp.gm:77-91)::

    Foreach(n: G.Nodes)(n.updated)
        Foreach(s: n.Nbrs)
            <s.dist_nxt; s.updated_nxt> min= <n.dist + w(e); True>;
    G.dist = G.dist_nxt; G.updated = G.updated_nxt; fin = !Exist(updated)

i.e. destinations take the min over their *in*-edges from currently-updated
sources; ``updated_nxt`` flags strict improvement (the compound min=
argmin assignment, ``gm_cpp_gen.cc:1563-1742``).  The deferred ``_nxt``
double buffer is exactly the functional update of the carried ``dist``.

This engine runs the relaxation as a pull over CSC slots (sorted segment
ids) inside one ``lax.while_loop``; SSSP and hop_dist are thin wrappers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops


class RelaxResult(NamedTuple):
    dist: jax.Array        # [N_pad]
    iterations: jax.Array  # supersteps executed


def min_relax(g: Graph, root, edge_len: Optional[jax.Array] = None,
              max_iter: Optional[int] = None,
              dist_dtype=jnp.int32) -> RelaxResult:
    """Run masked min-relaxation from ``root`` until fixpoint.

    ``edge_len``: optional [E_pad] edge weights in CSR slot order
    (``e.len`` of sssp.gm); unit weights when None (hop_dist).
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    inf = _inf(dist_dtype)
    ids = jnp.arange(g.n_pad, dtype=g.node_dtype)
    dist0 = jnp.where(ids == root, jnp.zeros((), dist_dtype), inf)
    dist0 = jnp.where(g.node_mask(), dist0, inf)
    upd0 = ids == root

    w_csc = (edge_len[g.e_rev2idx].astype(dist_dtype)
             if edge_len is not None else None)

    def step(state):
        dist, updated = state
        src_dist = dist[g.r_node_idx]
        src_upd = updated[g.r_node_idx]
        w = w_csc if w_csc is not None else jnp.ones((), dist_dtype)
        cand = jnp.where(src_upd, src_dist + w, inf)
        best = ops.sorted_segment_reduce(cand, g.r_node_idx_dst,
                                         g.r_begin, g.n_pad, "min")
        new_dist = jnp.minimum(dist, best)
        new_upd = new_dist < dist
        return new_dist, new_upd

    def not_done(state):
        _, updated = state
        return jnp.any(updated)

    (dist, _), stats = while_loop(step, not_done, (dist0, upd0), max_iter)
    return RelaxResult(dist=dist, iterations=stats.iterations)


def _inf(dtype):
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.asarray(jnp.inf, dtype)
    return jnp.asarray(jnp.iinfo(dtype).max, dtype)


def min_relax_np(begin, node_idx, root, edge_len=None):
    """Host float/int oracle (Bellman-Ford over out-edges) for tests."""
    import numpy as np
    N = begin.shape[0] - 1
    deg = np.diff(begin)
    src = np.repeat(np.arange(N), deg)
    dst = np.asarray(node_idx)[: src.shape[0]]
    w = np.ones_like(src) if edge_len is None else np.asarray(edge_len)
    INF = np.iinfo(np.int64).max
    dist = np.full(N, INF, dtype=np.int64)
    dist[root] = 0
    changed = True
    while changed:
        cand = np.where(dist[src] < INF, dist[src] + w, INF)
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        changed = bool((new < dist).any())
        dist = new
    return dist


def min_relax_profiled(g: Graph, root, edge_len=None,
                       max_iter=None, dist_dtype=jnp.int32):
    """Host-driven ``min_relax`` with per-superstep timing lines
    (``superstep[i] time=...``; utils.timing.profile_supersteps) —
    the -GMProfile path for hop_dist/sssp."""
    from ..utils.timing import profile_supersteps
    if max_iter is None:
        max_iter = g.num_nodes + 1
    inf = _inf(dist_dtype)
    ids = jnp.arange(g.n_pad, dtype=g.node_dtype)
    dist0 = jnp.where(ids == root, jnp.zeros((), dist_dtype), inf)
    dist0 = jnp.where(g.node_mask(), dist0, inf)
    upd0 = ids == root
    w_csc = (edge_len[g.e_rev2idx].astype(dist_dtype)
             if edge_len is not None else None)

    @jax.jit
    def step(state):
        dist, updated = state
        src_dist = dist[g.r_node_idx]
        src_upd = updated[g.r_node_idx]
        w = w_csc if w_csc is not None else jnp.ones((), dist_dtype)
        cand = jnp.where(src_upd, src_dist + w, inf)
        best = ops.sorted_segment_reduce(cand, g.r_node_idx_dst,
                                         g.r_begin, g.n_pad, "min")
        new_dist = jnp.minimum(dist, best)
        return new_dist, new_dist < dist

    def cond(state):
        return jnp.any(state[1])

    jax.block_until_ready(step((dist0, upd0)))  # compile outside timings
    dist, _ = profile_supersteps(step, (dist0, upd0), cond, max_iter)
    return RelaxResult(dist=dist, iterations=jnp.zeros((), jnp.int32))
