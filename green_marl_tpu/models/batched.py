"""Batched multi-instance algorithms: many roots / configs in lockstep.

The reference runs one algorithm instance per process (bc.gm iterates its
seed set sequentially; SURVEY.md §2.10 "batched instances: absent").  This
module adds the capability this build is for: advancing B instances per
superstep with one fused device program.

Layout: instance state is ``[N_pad, B]`` with the batch as the
**trailing (minor) axis** — a per-edge gather then touches one
contiguous B-wide row per endpoint, so edge maps stay dense row
loads/stores instead of strided scatters.  Edge traversal is chunked
with ``lax.scan`` over fixed-size slices of the padded edge arrays,
carrying the ``[N_pad, B]`` accumulator (donated, updated in place by
XLA).

Numeric note: distances are int32; convergence predicates reduce over both
axes so the loop runs until *every* instance is done (matching vmap
semantics of ``lax.while_loop`` but with explicit masking).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops

INT32_MAX = jnp.iinfo(jnp.int32).max


def _edge_chunks(g: Graph, chunk: int):
    """(chunk, n_chunks, pad_to) — edge arrays are padded with sentinel
    slots up to ``n_chunks * chunk`` so ``reshape`` is exact."""
    chunk = min(chunk, g.e_pad)
    n_chunks = -(-g.e_pad // chunk)
    return chunk, n_chunks, n_chunks * chunk


def _chunked(g: Graph, arr: jax.Array, n_chunks: int, chunk: int,
             fill) -> jax.Array:
    pad = n_chunks * chunk - arr.shape[0]
    if pad:
        arr = jnp.pad(arr, (0, pad), constant_values=fill)
    return arr.reshape(n_chunks, chunk)


class MultiBfsResult(NamedTuple):
    dist: jax.Array        # [N_pad, B] int32 (INT32_MAX = unreached)
    levels_run: jax.Array


@partial(jax.jit, static_argnames=("max_iter", "chunk"))
def multi_source_bfs(g: Graph, roots: jax.Array,
                     max_iter: Optional[int] = None,
                     chunk: int = 1 << 20) -> MultiBfsResult:
    """Level-synchronous BFS from ``roots[b]`` for every instance b.

    The frontier is implicit — ``dist == depth`` — so per-instance state is
    one int32 plane; supersteps run until no instance has a live frontier.
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    B = roots.shape[0]
    chunk, n_chunks, _ = _edge_chunks(g, chunk)
    mask = g.node_mask()

    dist0 = jnp.full((g.n_pad, B), INT32_MAX, jnp.int32)
    dist0 = dist0.at[roots, jnp.arange(B)].set(0)
    dist0 = jnp.where(mask[:, None], dist0, INT32_MAX)

    sent = g.sentinel
    csc_src = _chunked(g, g.r_node_idx, n_chunks, chunk, sent)
    csc_dst = _chunked(g, g.r_node_idx_dst, n_chunks, chunk, sent)

    def step(state):
        dist, depth = state
        frontier = dist == depth                      # [N_pad, B]

        def scan_body(hit, edges):
            src, dst = edges
            vals = frontier[src]                      # [chunk, B] gather
            return hit.at[dst].max(vals), None

        hit0 = jnp.zeros((g.n_pad, B), jnp.bool_)
        hit, _ = jax.lax.scan(scan_body, hit0, (csc_src, csc_dst))
        newly = hit & (dist == INT32_MAX) & mask[:, None]
        new_dist = jnp.where(newly, depth + 1, dist)
        return new_dist, depth + 1

    def not_done(state):
        dist, depth = state
        return jnp.any(dist == depth)

    (dist, _), stats = while_loop(
        step, not_done, (dist0, jnp.zeros((), jnp.int32)), max_iter)
    return MultiBfsResult(dist=dist, levels_run=stats.iterations)


class MultiPageRankResult(NamedTuple):
    rank: jax.Array        # [N_pad, B]
    diff: jax.Array        # [B]
    iterations: jax.Array


@partial(jax.jit, static_argnames=("max_iter", "chunk", "dtype"))
def multi_pagerank(g: Graph, damping: jax.Array, e=0.001,
                   max_iter: int = 100, chunk: int = 1 << 20,
                   dtype=jnp.float32) -> MultiPageRankResult:
    """PageRank with a per-instance damping factor ``damping[b]``.

    Converged instances are frozen (their rank plane stops changing) while
    the rest keep iterating; the loop exits when all are converged or at
    ``max_iter``.
    """
    B = damping.shape[0]
    chunk, n_chunks, _ = _edge_chunks(g, chunk)
    n = g.num_nodes
    mask = g.node_mask()
    inv_n = jnp.asarray(1.0 / n, dtype)
    e = jnp.asarray(e, dtype)
    d = damping.astype(dtype)[None, :]                # [1, B]

    out_deg = g.out_degree().astype(dtype)
    inv_deg = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1), 0.0)

    rank0 = jnp.where(mask[:, None], inv_n, 0).astype(dtype) \
        * jnp.ones((1, B), dtype)

    sent = g.sentinel
    csc_src = _chunked(g, g.r_node_idx, n_chunks, chunk, sent)
    csc_dst = _chunked(g, g.r_node_idx_dst, n_chunks, chunk, sent)

    def step(state):
        rank, diff, active = state
        contrib = rank * inv_deg[:, None]

        def scan_body(acc, edges):
            src, dst = edges
            return acc.at[dst].add(contrib[src]), None

        s0 = jnp.zeros((g.n_pad, B), dtype)
        s, _ = jax.lax.scan(scan_body, s0, (csc_src, csc_dst))
        val = (1 - d) * inv_n + d * s
        val = jnp.where(mask[:, None], val, 0)
        new_diff = jnp.sum(jnp.abs(val - rank), axis=0)  # [B]
        rank = jnp.where(active[None, :], val, rank)
        return rank, jnp.where(active, new_diff, diff), active & (new_diff > e)

    def not_done(state):
        return jnp.any(state[2])

    state0 = (rank0, jnp.zeros((B,), dtype), jnp.ones((B,), jnp.bool_))
    (rank, diff, _), stats = while_loop(step, not_done, state0, max_iter)
    return MultiPageRankResult(rank=rank, diff=diff,
                               iterations=stats.iterations)


# ---------------------------------------------------------------------------
# Degree-binned engine variants (ops.binned) — the batched fast path.
#
# The ``lax.scan``-over-edge-chunks versions above express the edge map as
# elementwise gathers + scatter-adds.  These variants run the same
# algorithms through the row-gather + fixed-width-reduce engine
# (ops/binned.py): one index read per slot serves all B instances and no
# scatter is needed.  State lives in *binned row order*; use
# ``bp.from_binned`` on results.
# ---------------------------------------------------------------------------

from ..ops import binned as _binned  # noqa: E402


@partial(jax.jit, static_argnames=("max_iter",))
def multi_source_bfs_binned(bp, roots: jax.Array,
                            max_iter: Optional[int] = None
                            ) -> MultiBfsResult:
    """Multi-source BFS on the binned engine.

    ``bp``: ``ops.binned.BinnedPull`` built over the *in*-neighbor view
    (``binned_in``) — a node joins the frontier when any in-neighbor is in
    it, which traverses out-edges forward (reference ST_RD bottom-up,
    ``gm_bfs_template.h:176-198``, run dense every level).
    ``roots``: [B] original node ids.  Result ``dist`` is [n_rows, B] in
    binned row order (INT32_MAX = unreached).
    """
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    B = roots.shape[0]
    root_rows = bp.inv_perm[roots]                    # [B] binned rows
    node_rows = bp.node_rows_mask()                   # [n_rows, 1]

    dist0 = jnp.full((bp.n_rows, B), INT32_MAX, jnp.int32)
    dist0 = dist0.at[root_rows, jnp.arange(B)].set(0)
    dist0 = jnp.where(node_rows, dist0, INT32_MAX)
    f0 = (dist0 == 0).astype(jnp.float32)

    def step(state):
        dist, f, depth = state
        hit = _binned.edge_map(bp, f, "or")           # [n_rows, B]
        newly = (hit > 0) & (dist == INT32_MAX) & node_rows
        dist = jnp.where(newly, depth + 1, dist)
        return dist, newly.astype(jnp.float32), depth + 1

    def not_done(state):
        return jnp.any(state[1] > 0)

    state0 = (dist0, f0, jnp.zeros((), jnp.int32))
    (dist, _, _), stats = while_loop(step, not_done, state0, max_iter)
    return MultiBfsResult(dist=dist, levels_run=stats.iterations)


@partial(jax.jit, static_argnames=("max_iter", "dtype"))
def multi_pagerank_binned(bp, out_deg_binned: jax.Array,
                          damping: jax.Array, e=0.001,
                          max_iter: int = 100,
                          dtype=jnp.float32) -> MultiPageRankResult:
    """PageRank (per-instance damping) on the binned engine.

    ``out_deg_binned``: [n_nodes] out-degrees in binned row order
    (``bp.to_binned(g.out_degree()[:N])``); ``bp`` is over in-neighbors.
    Result rank is [n_rows, B] in binned row order.
    """
    B = damping.shape[0]
    n = bp.n_nodes
    node_rows = bp.node_rows_mask()
    inv_n = jnp.asarray(1.0 / n, dtype)
    e = jnp.asarray(e, dtype)
    d = damping.astype(dtype)[None, :]

    deg = out_deg_binned.astype(dtype)
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1), 0.0)
    inv_deg = jnp.concatenate(
        [inv_deg, jnp.zeros((bp.n_rows - n,), dtype)])[:, None]

    rank0 = jnp.where(node_rows, inv_n, 0).astype(dtype) \
        * jnp.ones((1, B), dtype)

    def step(state):
        rank, diff, active = state
        contrib = rank * inv_deg                      # pad rows stay 0
        s = _binned.edge_map(bp, contrib, "sum")
        val = (1 - d) * inv_n + d * s
        val = jnp.where(node_rows, val, 0)
        new_diff = jnp.sum(jnp.abs(val - rank), axis=0)
        rank = jnp.where(active[None, :], val, rank)
        return rank, jnp.where(active, new_diff, diff), \
            active & (new_diff > e)

    def not_done(state):
        return jnp.any(state[2])

    state0 = (rank0, jnp.zeros((B,), dtype), jnp.ones((B,), jnp.bool_))
    (rank, diff, _), stats = while_loop(step, not_done, state0, max_iter)
    return MultiPageRankResult(rank=rank, diff=diff,
                               iterations=stats.iterations)


@partial(jax.jit, donate_argnums=(1,), static_argnames=("slot_chunk",))
def _pr_step_paged(bp, rank, w_slot, damp, slot_chunk=None):
    """One PageRank superstep with a DONATED rank plane and the
    contrib product folded into per-slot weights: ``rank*inv_deg`` as
    a [n_rows, B] temp costs a full plane (5 GB at B=256); gathering
    ``rank`` rows and multiplying by ``w_slot = inv_deg[slot_src]``
    inside the edge_map combine does the same math with a [S_tot]
    vector (fp rounding differs in ulps: per-slot instead of per-row
    product)."""
    nr = bp.node_rows_mask()
    dtype = rank.dtype
    inv_n = jnp.asarray(1.0 / bp.n_nodes, dtype)
    s = _binned.edge_map(bp, rank, "sum", slot_vals=w_slot,
                         combine=lambda x, w: x * w,
                         slot_chunk=slot_chunk)
    val = jnp.where(nr, (1 - damp)[None, :] * inv_n
                    + damp[None, :] * s, jnp.zeros((), dtype))
    diff = jnp.sum(jnp.abs(val - rank), axis=0)
    return val, diff


def multi_pagerank_binned_paged(bp, out_deg_binned: jax.Array,
                                damping: jax.Array, e=0.001,
                                max_iter: int = 100,
                                dtype=jnp.float32,
                                slot_chunk: Optional[int] = None
                                ) -> MultiPageRankResult:
    """Memory-paged wide-plane variant of ``multi_pagerank_binned``
    (the B=8192-BFS treatment applied to PageRank): host-stepped loop,
    donated rank carry, slot-folded contrib — fits wider planes than the
    fused while-loop, whose XLA temps hold several planes at once.

    Semantics differ from the fused version in ONE way: converged
    instances are not frozen individually — ALL instances iterate
    until every diff <= e (identical results for the fixed-iteration
    e=0 benchmark protocol; values match the fused version to fp32
    ulps — the contrib product rounds per slot, not per row)."""
    B = damping.shape[0]
    n = bp.n_nodes
    node_rows = bp.node_rows_mask()
    inv_n = jnp.asarray(1.0 / n, dtype)
    deg = out_deg_binned.astype(dtype)
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1), 0.0)
    inv_deg = jnp.concatenate(
        [inv_deg, jnp.zeros((bp.n_rows - n,), dtype)])
    w_slot = inv_deg[bp.slot_src]          # [S_tot], one-time gather
    damp = damping.astype(dtype)
    rank = jnp.where(node_rows, inv_n, 0).astype(dtype) \
        * jnp.ones((1, B), dtype)
    diff = jnp.zeros((B,), dtype)
    it = 0
    import numpy as _np
    while it < max_iter:
        rank, diff = _pr_step_paged(bp, rank, w_slot, damp,
                                    slot_chunk=slot_chunk)
        it += 1
        if float(_np.max(_np.asarray(jax.device_get(diff)))) <= float(e):
            break
    return MultiPageRankResult(rank=rank, diff=diff,
                               iterations=jnp.asarray(it, jnp.int32))


class BitBfsResult(NamedTuple):
    visited: jax.Array     # [n_rows, LANES] uint8/16/32 bit planes
    #                        (binned order)
    levels_run: jax.Array
    reached: jax.Array     # [B] per-instance reached-node counts
    traversed: jax.Array   # [B] per-instance Graph500 traversed edges


# Row-chunk size for the popstats bit expansion: the per-bit int32
# view of the plane costs 4x its bytes, so at twitter-class n_rows
# (>2^24) a whole-plane expansion transient is several GB.  Chunking
# caps the transient at ~0.5 GB per bit with identical int32 sums.
_POP_CH = 1 << 20


def _bit_popstats(newly, deg_rows, lanes, bits=8):
    """Per-instance (lane*8+bit) counts and degree-weighted counts from a
    [n_rows, lanes] uint8 plane.

    Counters are per-instance int32: a single instance traverses at most
    E edges (< 2^31 for every supported workload incl. twitter_rv's
    1.46B); callers aggregate across instances on the host in int64 —
    device-side int64 is unavailable without jax_enable_x64."""
    one = jnp.ones((), newly.dtype)
    n_rows = newly.shape[0]
    starts = range(0, n_rows, _POP_CH)
    cnt = jnp.zeros((lanes, bits), jnp.int32)
    trav = jnp.zeros((lanes, bits), jnp.int32)
    for s in starts:
        blk = newly[s:s + _POP_CH]
        dblk = deg_rows[s:s + _POP_CH]
        cnts = []
        travs = []
        for i in range(bits):
            p = ((blk >> i) & one).astype(jnp.int32)   # [<=CH, lanes]
            cnts.append(jnp.sum(p, axis=0))             # [lanes]
            travs.append(jnp.sum(p * dblk[:, None], axis=0,
                                 dtype=jnp.int32))
        cnt = cnt + jnp.stack(cnts, axis=1)
        trav = trav + jnp.stack(travs, axis=1)
    # instance index convention: b = lane * 8 + bit
    return cnt.reshape(-1), trav.reshape(-1)


@partial(jax.jit, static_argnames=("max_iter", "plane_bits"))
def multi_source_bfs_bits(bp, roots: jax.Array, deg_rows: jax.Array,
                          max_iter: Optional[int] = None,
                          plane_bits: int = 8) -> BitBfsResult:
    """Bit-packed multi-source BFS: ``plane_bits`` instances per lane —
    with the engine's 128-lane tables, up to 128*32 = 4096 BFS
    instances per row gather (uint32 planes).

    A row gather pays its index read and random access once for the
    whole row, so packing instances into bits multiplies the instances
    served per gathered row by the pack factor.  Plays the role of
    running the reference binary B times (it has no batched mode;
    SURVEY.md §2.10) at a tiny fraction of the cost.

    ``roots``: [B <= 128*plane_bits] original node ids; instance b lives
    at lane b//plane_bits, bit b%plane_bits.  ``deg_rows``: [n_rows]
    int32 out-degrees (binned, padded) for Graph500 accounting.
    Per-instance reached/traversed are computed ONCE from the final
    visited planes (they depend only on the reached set), so the
    superstep loop does no per-bit work.  Level arrays are not
    materialized — callers needing distances use
    ``multi_source_bfs_binned``.
    """
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[plane_bits]
    B = roots.shape[0]
    lanes = (B + plane_bits - 1) // plane_bits
    root_rows = bp.inv_perm[roots]
    node_rows = bp.node_rows_mask()

    bits0 = jnp.zeros((bp.n_rows, lanes), dt)
    b_ix = jnp.arange(B, dtype=jnp.int32)
    # scatter-OR of the root bits: .add is exact because every instance
    # owns a distinct bit (scatter-max would keep only the highest bit
    # when two roots share a row and lane)
    bits0 = bits0.at[root_rows, b_ix // plane_bits].add(
        (jnp.ones((), dt) << (b_ix % plane_bits).astype(dt)))
    bits0 = jnp.where(node_rows, bits0, jnp.zeros((), dt))

    def step(state):
        visited, frontier, depth = state
        hit = _binned.edge_map(bp, frontier, "bor")
        newly = hit & ~visited
        newly = jnp.where(node_rows, newly, jnp.zeros((), dt))
        return (visited | newly, newly, depth + 1)

    def not_done(state):
        return jnp.any(state[1] != 0)

    state0 = (bits0, bits0, jnp.zeros((), jnp.int32))
    (visited, _, _), stats = while_loop(step, not_done, state0, max_iter)
    cnt, trav = _bit_popstats(visited, deg_rows, lanes,
                              bits=plane_bits)
    return BitBfsResult(visited=visited, levels_run=stats.iterations,
                        reached=cnt[:B], traversed=trav[:B])


@partial(jax.jit, donate_argnums=(1,), static_argnames=("slot_chunk",))
def _bits_step_paged(bp, visited, slot_chunk=None):
    """One closure superstep over the VISITED plane alone, donated.

    The fused while-loop holds ~5.7 plane buffers in XLA temps
    (compile-time ``memory_analysis``); this step keeps one donated
    plane.  A separate frontier plane buys nothing here — the dense
    bit-plane edge_map gathers every slot regardless of frontier
    sparsity, and the monotone closure ``visited |= edge_map(visited)``
    converges in exactly as many supersteps as frontier BFS."""
    dt = visited.dtype
    hit = _binned.edge_map(bp, visited, "bor", slot_chunk=slot_chunk)
    new_vis = jnp.where(bp.node_rows_mask(), visited | hit, visited)
    return new_vis, jnp.any(new_vis != visited)


@partial(jax.jit, static_argnames=("plane_bits",))
def _bits_seed(bp, roots, plane_bits: int = 8):
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[plane_bits]
    B = roots.shape[0]
    root_rows = bp.inv_perm[roots]
    b_ix = jnp.arange(B, dtype=jnp.int32)
    bits0 = jnp.zeros((bp.n_rows, (B + plane_bits - 1) // plane_bits),
                      dt)
    bits0 = bits0.at[root_rows, b_ix // plane_bits].add(
        (jnp.ones((), dt) << (b_ix % plane_bits).astype(dt)))
    return jnp.where(bp.node_rows_mask(), bits0, jnp.zeros((), dt))


@partial(jax.jit, static_argnames=("plane_bits",))
def _bits_stats(visited, deg_rows, plane_bits: int = 8):
    lanes = visited.shape[1]
    return _bit_popstats(visited, deg_rows, lanes, bits=plane_bits)


def multi_source_bfs_bits_paged(bp, roots: jax.Array,
                                deg_rows: jax.Array,
                                max_iter: Optional[int] = None,
                                plane_bits: int = 8,
                                slot_chunk: Optional[int] = None
                                ) -> BitBfsResult:
    """Memory-paged variant of ``multi_source_bfs_bits`` for planes
    that do not fit the fused loop: a HOST-stepped level loop with
    donated plane carries (one device->host flag read per level)
    instead of the fused ``lax.while_loop`` whose XLA temps hold ~5.7
    plane buffers.  Same results, bit for bit."""
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    B = roots.shape[0]
    visited = _bits_seed(bp, roots, plane_bits)
    depth = 0
    while depth < max_iter:
        visited, changed = _bits_step_paged(bp, visited,
                                            slot_chunk=slot_chunk)
        depth += 1
        if not bool(changed):       # one device fetch per level
            break
    cnt, trav = _bits_stats(visited, deg_rows, plane_bits)
    return BitBfsResult(visited=visited,
                        levels_run=jnp.asarray(depth, jnp.int32),
                        reached=cnt[:B], traversed=trav[:B])
