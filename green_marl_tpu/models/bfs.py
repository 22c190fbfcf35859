"""Direction-optimizing level-synchronous BFS.

Equivalent of the reference's BFS template
(``apps/output_cpp/gm_graph/inc/gm_bfs_template.h:14-756``), which drives
the ``InBFS``/``InRBFS`` constructs (bc.gm etc.).  The reference runs a
state machine ST_SMALL→ST_QUE (top-down frontier queue) →ST_RD (bottom-up
read-based sweep) with the switch thresholds ``next_count >= 0.05*N`` or
``>= 1024 && >= 5*curr`` (``gm_bfs_template.h:359-414,720-721``).

Here both directions are shape-static programs selected per level by
``lax.switch`` on the frontier's out-edge count:

* top-down ("push", ST_QUE): compact the frontier bitmap, enumerate its
  CSR slots into a fixed edge-budget buffer (4K/64K/1M tiers) and
  scatter-or the destinations — O(budget), not O(E), so a 100-node
  frontier costs a small buffer;
* bottom-up ("pull", ST_RD): every node tests whether any in-neighbor is
  in the frontier via a fixed-order segment sweep over all edges
  (``gm_bfs_template.h:176-198``) — chosen when the frontier's edge
  count overflows every push tier, the same density regime where the
  reference flips to its read-based state.

Levels are recorded in ``level[v]`` (reference ``visited_level``); the
backward sweep for betweenness-centrality style passes iterates levels in
reverse (``do_bfs_reverse``, ``gm_bfs_template.h:273``), which here is a
``fori_loop`` over recorded level masks — see ``models.bc``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import scan_reduce
from ..ops import segment as ops

class BfsResult(NamedTuple):
    level: jax.Array       # [N_pad] int32, -1 = unreached
    levels_run: jax.Array  # number of levels expanded
    reached: jax.Array     # total reached node count


def _push_expand(g: Graph, frontier, push_begin, push_nbr, e_cap: int):
    """Top-down expand with a static edge budget ``e_cap`` (ST_QUE).

    * frontier compaction by ``lax.sort`` of masked ids;
    * segmented slot expansion via run-start marks + a max-scan
      (a searchsorted over [n_pad] would cost ~log2(n_pad) dependent
      gathers per output slot);
    * destination OR via one scatter.
    Work is O(n_pad + e_cap) regardless of E, which is the whole point
    of the direction switch: a 100-node frontier costs a small buffer,
    not a full edge sweep.
    """
    n_pad = g.n_pad
    ids_all = jnp.arange(n_pad, dtype=jnp.int32)
    ids = jax.lax.sort(jnp.where(frontier, ids_all, jnp.int32(n_pad)))
    valid = ids < g.num_nodes
    idc = jnp.minimum(ids, g.num_nodes - 1)
    deg = jnp.where(valid,
                    (push_begin[idc + 1] - push_begin[idc]).astype(
                        jnp.int32), 0)
    cum = jnp.cumsum(deg)
    W = cum[-1]                       # total frontier out-edges
    start = cum - deg                 # run start per frontier position
    # run-owner per output slot: scatter each position's index at its
    # run start (clipped into the budget), then propagate with cummax
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    mark_at = jnp.where(valid & (deg > 0) & (start < e_cap),
                        start, jnp.int32(e_cap))
    marks = jnp.zeros((e_cap,), jnp.int32).at[mark_at].max(
        pos + 1, mode="drop")
    owner = jax.lax.associative_scan(jnp.maximum, marks) - 1
    owner = jnp.maximum(owner, 0)
    i = jnp.arange(e_cap, dtype=jnp.int32)
    base = push_begin[idc[owner]].astype(jnp.int32)
    off = i - start[owner]
    slot = jnp.clip(base + off, 0, push_nbr.shape[0] - 1)
    live = i < jnp.minimum(W, e_cap)
    dst = push_nbr[slot].astype(jnp.int32)
    hit = ops.segment_max(live.astype(jnp.int8), dst, n_pad,
                          sorted_ids=False) > 0
    return hit


@partial(jax.jit, static_argnames=("max_iter", "reverse", "direction"))
def bfs(g: Graph, root, max_iter: int | None = None,
        reverse: bool = False, direction: str = "auto") -> BfsResult:
    """Forward BFS from ``root`` over out-edges (in-edges if ``reverse``).

    ``direction``: "auto" switches per level between the push tiers and
    the pull sweep (reference state machine ST_QUE->ST_RD); "pull" and
    "push" force one branch (testing / pathological graphs).
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    n_pad = g.n_pad
    ids = jnp.arange(n_pad, dtype=g.node_dtype)
    node_mask = g.node_mask()

    # Pull direction arrays: a node v joins the next frontier if one of its
    # in-neighbors (out-neighbors when reverse) is in the current frontier.
    # Scatter-free: OR = exact integer segment-count > 0 (ops.scan_reduce).
    if reverse:
        e_src, offsets = g.node_idx, g.begin       # traverse edges backwards
        push_begin, push_nbr = g.r_begin, g.r_node_idx
        out_deg = g.in_degree()
    else:
        e_src, offsets = g.r_node_idx, g.r_begin
        push_begin, push_nbr = g.begin, g.node_idx
        out_deg = g.out_degree()
    out_deg = out_deg.astype(jnp.int32)

    # Static push-budget tiers: smallest buffer that fits the frontier's
    # out-edge count wins; overflowing every tier -> pull (the reference
    # flips to ST_RD at next_count >= 0.05*N or >= 1024 && >= 5*curr,
    # gm_bfs_template.h:359-414 — here the budget is edge-based, which
    # is the same quantity the cost actually follows).  The tier sizes
    # are not yet measured on the GPU (ROADMAP 1.3).
    e_pad = int(push_nbr.shape[0])
    tiers = []
    for cap in (4096, 65536, 1 << 20, 1 << 21):
        if cap < e_pad // 2:
            tiers.append(cap)

    level0 = jnp.where(ids == root, 0, -1).astype(jnp.int32)
    level0 = jnp.where(node_mask, level0, -1)
    frontier0 = (ids == root) & node_mask

    def expand_pull(frontier):
        """Bottom-up: segment-or over in-edges (ST_RD)."""
        vals = frontier[e_src].astype(jnp.int32)
        return scan_reduce.segment_sum_by_offsets(vals, offsets, n_pad) > 0

    def step(state):
        level, frontier, depth, count = state
        visited = level >= 0
        if direction == "pull" or not tiers:
            hit = expand_pull(frontier)
        elif direction == "push":
            # forced push: full edge budget (never truncates)
            hit = _push_expand(g, frontier, push_begin, push_nbr, e_pad)
        else:
            fe = jnp.sum(jnp.where(frontier, out_deg, 0))
            branches = [partial(_push_expand, g, frontier, push_begin,
                                push_nbr, cap) for cap in tiers]
            branches.append(lambda: expand_pull(frontier))
            idx = sum((fe > cap).astype(jnp.int32) for cap in tiers)
            hit = jax.lax.switch(idx, branches)
        nxt = hit & ~visited & node_mask
        new_level = jnp.where(nxt, depth + 1, level)
        return (new_level, nxt, depth + 1,
                count + jnp.sum(nxt.astype(jnp.int32)))

    def not_done(state):
        _, frontier, _, _ = state
        return jnp.any(frontier)

    state0 = (level0, frontier0, jnp.zeros((), jnp.int32),
              jnp.sum(frontier0.astype(jnp.int32)))
    (level, _, depth, count), stats = while_loop(
        step, not_done, state0, max_iter)
    return BfsResult(level=level, levels_run=stats.iterations,
                     reached=count)


@partial(jax.jit, static_argnames=("max_iter",))
def bfs_many_sequential(g: Graph, roots: jax.Array,
                        max_iter: int | None = None):
    """Run full BFS from each of ``roots`` *sequentially on device* in one
    compiled program; returns (total_levels, total_reached,
    per_root_traversed_edges [R] int32, last_level_array).

    One host dispatch amortized over ``len(roots)`` complete BFS runs
    (the reference measures each binary run separately —
    ``common_main.h:196-205``).

    Traversed edges are returned per root (each < E < 2^31); sum them on
    the host in int64 — an int64 device accumulator would silently
    truncate without jax_enable_x64.
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    deg = g.out_degree().astype(jnp.int32)
    n_roots = roots.shape[0]

    def one(i, carry):
        tot_lv, tot_reach, trav_arr, _ = carry
        res = bfs(g, roots[i], max_iter=max_iter)
        trav = jnp.sum(jnp.where(res.level >= 0, deg, 0))
        return (tot_lv + res.levels_run, tot_reach + res.reached,
                trav_arr.at[i].set(trav), res.level)

    init = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((n_roots,), jnp.int32),
            jnp.zeros((g.n_pad,), jnp.int32))
    return jax.lax.fori_loop(0, n_roots, one, init)


def level_masks(level: jax.Array, max_levels: int) -> jax.Array:
    """[max_levels, N_pad] bool — per-level membership, for reverse sweeps."""
    return (jnp.arange(max_levels, dtype=jnp.int32)[:, None]
            == level[None, :])


def bfs_np(begin, node_idx, root):
    """Host oracle for tests."""
    import collections
    import numpy as np
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    level = np.full(N, -1, np.int64)
    level[root] = 0
    q = collections.deque([root])
    while q:
        u = q.popleft()
        for v in node_idx[begin[u]:begin[u + 1]]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    return level
