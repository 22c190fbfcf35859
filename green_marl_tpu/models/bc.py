"""Betweenness centrality (Brandes), estimated over a seed set.

Reimplements ``apps/src/bc.gm:1-31`` (and bc_adj/bc_random variants): for
each seed s, a forward BFS accumulates path counts ``sigma`` over BFS
parents (``v.UpNbrs``), then the reverse sweep accumulates dependencies
``delta`` over BFS children (``v.DownNbrs``) — the reference compiles this
to its direction-optimizing BFS template with ``save_child`` enabled
(``gm_cpp_gen_bfs.cc``, ``gm_bfs_template.h:273``).

Device formulation: one forward BFS gives ``level[v]``; "UpNbrs" are exactly
in-neighbors one level up and "DownNbrs" out-neighbors one level down, so
both sweeps are per-level masked edge maps via the sorted-segment-reduce
kernel — no parent lists are materialized (the level array plays
``visited_level``'s role).  Seeds are processed sequentially on device
(reference iterates its ``Node_Sequence`` sequentially too);
``bc_batched`` processes all seeds per level in lockstep when memory
allows.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..graph.csr import Graph
from ..ops import segment as ops
from .bfs import bfs


class BCResult(NamedTuple):
    bc: jax.Array          # [N_pad] float32


def _one_seed(g: Graph, seed, bc_acc, max_iter: int):
    mask = g.node_mask()
    res = bfs(g, seed, max_iter=max_iter)
    level = res.level                        # [-1 unreached]
    n_levels = res.levels_run + 1

    sigma0 = jnp.where(jnp.arange(g.n_pad) == seed, 1.0, 0.0).astype(
        jnp.float32)

    # forward: sigma[v] = sum over in-nbrs w at level[v]-1 of sigma[w]
    def fwd(l, sigma):
        contrib = jnp.where(level == l - 1, sigma, 0.0)
        s = ops.in_nbr_sum(g, contrib)
        return jnp.where(level == l, s, sigma)

    sigma = jax.lax.fori_loop(1, n_levels, fwd, sigma0)

    # backward: delta[v] = sum over out-nbrs w at level[v]+1 of
    #           sigma[v]/sigma[w] * (1 + delta[w])
    safe_sigma = jnp.where(sigma > 0, sigma, 1.0)

    def bwd(i, delta):
        l = n_levels - 2 - i                 # levels L-2 .. 0
        term = jnp.where(level == jnp.maximum(l + 1, 0),
                         (1.0 + delta) / safe_sigma, 0.0)
        s = ops.out_nbr_sum(g, term)
        cand = sigma * s
        return jnp.where(level == l, cand, delta)

    delta = jax.lax.fori_loop(0, jnp.maximum(n_levels - 1, 0), bwd,
                              jnp.zeros((g.n_pad,), jnp.float32))
    return bc_acc + jnp.where(mask, delta, 0.0)


@partial(jax.jit, static_argnames=("max_iter",))
def bc(g: Graph, seeds: jax.Array, max_iter: int | None = None) -> BCResult:
    """``seeds``: [S] node ids (the reference's ``Seeds`` sequence)."""
    if max_iter is None:
        max_iter = g.num_nodes + 1

    def body(i, acc):
        return _one_seed(g, seeds[i], acc, max_iter)

    bc_acc = jax.lax.fori_loop(0, seeds.shape[0], body,
                               jnp.zeros((g.n_pad,), jnp.float32))
    return BCResult(bc=bc_acc)


def bc_np(begin, node_idx, seeds):
    """Host Brandes oracle (literal bc.gm semantics)."""
    import collections
    import numpy as np
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    BC = np.zeros(N)
    for s in seeds:
        level = np.full(N, -1)
        sigma = np.zeros(N)
        level[s] = 0
        sigma[s] = 1.0
        q = collections.deque([s])
        order = []
        while q:
            u = q.popleft()
            order.append(u)
            for v in node_idx[begin[u]:begin[u + 1]]:
                if level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        # forward sigma / backward delta by level over the BFS DAG
        deg = np.diff(begin)
        src = np.repeat(np.arange(N), deg)
        dst = node_idx[: src.shape[0]]
        maxl = level.max()
        sigma = np.zeros(N)
        sigma[s] = 1.0
        for l in range(1, maxl + 1):
            m = (level[src] == l - 1) & (level[dst] == l)
            np.add.at(sigma, dst[m], sigma[src[m]])
        delta = np.zeros(N)
        for l in range(maxl - 1, -1, -1):
            m = (level[src] == l) & (level[dst] == l + 1)
            contrib = np.zeros(N)
            np.add.at(contrib, src[m],
                      (1.0 + delta[dst[m]]) /
                      np.where(sigma[dst[m]] > 0, sigma[dst[m]], 1.0))
            delta = np.where(level == l, sigma * contrib, delta)
        BC += np.where(level >= 0, delta, 0.0)
    return BC
