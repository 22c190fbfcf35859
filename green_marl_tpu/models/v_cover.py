"""Greedy vertex cover (``apps/src/v_cover.gm``).

Reference semantics: repeatedly pick the edge (s, t) maximizing
``s.Deg + t.Deg`` over edges with not-both-endpoints-covered (the compound
``<max_val; from,to,e> max=`` argmax assignment, compiled to the
test-and-test-and-set path ``gm_cpp_gen.cc:1563-1742``), zero both
degrees, mark covered, select the edge, and subtract ``max_val`` from the
remaining total; return the covered-node count.

Device formulation: the argmax over edges is a dense masked reduction with a
deterministic tie-break (lowest CSR slot — the reference's OpenMP argmax
is first-writer-wins, i.e. nondeterministic; normalized here).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..engine.superstep import while_loop
from ..graph.csr import Graph


class VCoverResult(NamedTuple):
    select: jax.Array      # [E_pad] bool, selected edges (CSR slots)
    count: jax.Array       # covered node count
    iterations: jax.Array


@partial(jax.jit, static_argnames=("max_iter",))
def v_cover(g: Graph, max_iter: int | None = None) -> VCoverResult:
    if max_iter is None:
        max_iter = g.num_edges + 1
    e_src = g.node_idx_src
    e_dst = g.node_idx
    emask = g.edge_mask()

    deg0 = (g.out_degree() + g.in_degree()).astype(jnp.int32)
    remain0 = jnp.asarray(2 * g.num_edges, jnp.int32)

    def step(state):
        deg, covered, select, remain, it = state
        ok = emask & ~(covered[e_src] & covered[e_dst])
        val = jnp.where(ok, deg[e_src] + deg[e_dst], -1)
        best = jnp.max(val)
        eidx = jnp.argmax(val)              # first (lowest slot) maximum
        s = e_src[eidx]
        t = e_dst[eidx]
        deg = deg.at[s].set(0).at[t].set(0)
        covered = covered.at[s].set(True).at[t].set(True)
        select = select.at[eidx].set(True)
        remain = remain - best
        return deg, covered, select, remain, it + 1

    def not_done(state):
        return state[3] > 0

    state0 = (deg0, jnp.zeros((g.n_pad,), bool),
              jnp.zeros((g.e_pad,), bool), remain0,
              jnp.zeros((), jnp.int32))
    (deg, covered, select, remain, it), stats = while_loop(
        step, not_done, state0, max_iter)
    count = jnp.sum((covered & g.node_mask()).astype(jnp.int32))
    return VCoverResult(select=select, count=count,
                        iterations=stats.iterations)


def v_cover_np(begin, node_idx):
    """Host oracle (same deterministic tie-break)."""
    import numpy as np
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    deg_out = np.diff(begin)
    E = node_idx.shape[0]
    src = np.repeat(np.arange(N), deg_out)
    deg_in = np.bincount(node_idx, minlength=N)
    deg = (deg_out + deg_in).astype(np.int64)
    covered = np.zeros(N, bool)
    select = np.zeros(E, bool)
    remain = 2 * E
    while remain > 0:
        ok = ~(covered[src] & covered[node_idx])
        val = np.where(ok, deg[src] + deg[node_idx], -1)
        e = int(np.argmax(val))
        best = val[e]
        s, t = src[e], node_idx[e]
        deg[s] = deg[t] = 0
        covered[s] = covered[t] = True
        select[e] = True
        remain -= best
    return select, int(covered.sum())
