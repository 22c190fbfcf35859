"""PageRank power iteration.

Reimplementation of ``apps/src/pagerank.gm:1-20`` as compiled by
the reference cpp backend (pull-sum over in-neighbors, ``@``-deferred rank
write = double buffering, L1-diff convergence, iteration cap):

.. code-block:: none

    G.pg_rank = 1 / N;
    Do {
        diff = 0.0;
        Foreach (t: G.Nodes) {
            Double val = (1-d)/N + d * Sum(w: t.InNbrs){ w.pg_rank / w.OutDegree() };
            diff += | val - t.pg_rank |;
            t.pg_rank <= val @ t;      // deferred write
        }
        cnt++;
    } While ((diff > e) && (cnt < max));

The deferred write + per-iteration barrier is exactly a functional update
inside a ``lax.while_loop``; the ``diff`` reduction (reference: OpenMP
reduction privatization, ``gm_cpp_opt_reduce_scalar.cc``) is a fixed-order
masked sum, so results are bit-deterministic.

Defaults (e=0.001, d=0.85, max=100) mirror
``apps/output_cpp/src/pagerank_main.cc:11-15``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..engine.superstep import converge_loop, LoopStats
from ..graph.csr import Graph
from ..ops import segment as ops


class PageRankResult(NamedTuple):
    rank: jax.Array        # [N_pad] (junk rows zeroed)
    diff: jax.Array        # final L1 diff
    iterations: jax.Array  # supersteps executed


@partial(jax.jit, static_argnames=("max_iter", "dtype"))
def pagerank(g: Graph, e=0.001, d=0.85, max_iter: int = 100,
             dtype=jnp.float32) -> PageRankResult:
    """Run PageRank to convergence on one device.

    ``dtype`` is float32 by default; pass ``jnp.float64`` under
    ``jax_enable_x64`` on CPU for reference (double) parity.
    """
    n = g.num_nodes
    mask = g.node_mask()
    inv_n = jnp.asarray(1.0 / n, dtype)
    e = jnp.asarray(e, dtype)
    d = jnp.asarray(d, dtype)

    out_deg = g.out_degree().astype(dtype)
    # Guarded reciprocal: nodes with out-degree 0 contribute nothing (the
    # reference never evaluates rank/outdeg for such nodes because the pull
    # only visits w that have at least the in-edge being pulled).
    inv_deg = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1), 0.0)

    rank0 = jnp.where(mask, inv_n, jnp.zeros((), dtype))

    def step(state):
        rank, _ = state
        contrib = rank * inv_deg
        s = ops.in_nbr_sum(g, contrib)
        val = (1 - d) * inv_n + d * s
        val = jnp.where(mask, val, jnp.zeros((), dtype))
        diff = jnp.sum(jnp.abs(val - rank))
        return (val, diff)

    def not_done(state):
        _, diff = state
        return diff > e

    (rank, diff), stats = converge_loop(
        step, not_done, (rank0, jnp.zeros((), dtype)), max_iter)
    return PageRankResult(rank=rank, diff=diff, iterations=stats.iterations)


def pagerank_np(begin, node_idx, e=0.001, d=0.85, max_iter=100):
    """Host-side float64 oracle (direct transliteration of the .gm source)
    for tests; mirrors the reference binary's semantics."""
    import numpy as np
    N = begin.shape[0] - 1
    deg = np.diff(begin)
    src = np.repeat(np.arange(N), deg)
    dst = np.asarray(node_idx)[: src.shape[0]]
    rank = np.full(N, 1.0 / N)
    cnt = 0
    while True:
        contrib = np.where(deg > 0, rank / np.maximum(deg, 1), 0.0)
        s = np.zeros(N)
        np.add.at(s, dst, contrib[src])
        val = (1 - d) / N + d * s
        diff = np.abs(val - rank).sum()
        rank = val
        cnt += 1
        if not (diff > e and cnt < max_iter):
            return rank, diff, cnt


def pagerank_profiled(g: Graph, e=0.001, d=0.85, max_iter: int = 100,
                      dtype=jnp.float32) -> PageRankResult:
    """Host-driven variant with per-superstep device timing lines
    (``superstep[i] time=...``); see utils.timing.profile_supersteps.
    Same arithmetic as :func:`pagerank` (one jitted step per line)."""
    from ..utils.timing import profile_supersteps
    n = g.num_nodes
    mask = g.node_mask()
    inv_n = jnp.asarray(1.0 / n, dtype)
    e = jnp.asarray(e, dtype)
    d = jnp.asarray(d, dtype)
    out_deg = g.out_degree().astype(dtype)
    inv_deg = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1), 0.0)
    rank0 = jnp.where(mask, inv_n, jnp.zeros((), dtype))

    @jax.jit
    def step(state):
        rank, _, it = state
        contrib = rank * inv_deg
        s = ops.in_nbr_sum(g, contrib)
        val = (1 - d) * inv_n + d * s
        val = jnp.where(mask, val, jnp.zeros((), dtype))
        diff = jnp.sum(jnp.abs(val - rank))
        return (val, diff, it + 1)

    def cond(state):
        rank, diff, it = state
        return jnp.logical_and(it < max_iter,
                               jnp.logical_or(it == 0, diff > e))

    state0 = (rank0, jnp.zeros((), dtype), jnp.zeros((), jnp.int32))
    jax.block_until_ready(step(state0))  # compile outside the timings
    rank, diff, it = profile_supersteps(step, state0, cond, max_iter)
    return PageRankResult(rank=rank, diff=diff, iterations=it)
