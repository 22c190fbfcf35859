"""Community detection by label propagation (``apps/src/communities.gm``).

Reference semantics: each node counts its out-neighbors' community labels
in a ``Map<Node, Int>`` and adopts ``T.GetMaxKey()`` unless its current
label already has the maximal count (``T.HasMaxValue(x.Comm)``).

Device formulation: per superstep, build (dst-node, neighbor-label) pairs,
sort them, and run length-encode with the sorted-segment machinery:

* sort keys ``dst * n_pad + label`` — one ``lax.sort`` over E per step;
* run lengths = count per (dst, label) pair (integer prefix trick);
* per dst: max count and its smallest label (deterministic tie-break —
  the reference's hash-map iteration order is unspecified, so ties are
  normalized; documented deviation).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..engine.superstep import converge_loop
from ..graph.csr import Graph
from ..ops import segment as ops


class CommunitiesResult(NamedTuple):
    comm: jax.Array        # [N_pad] node label; -1 on padding
    iterations: jax.Array


@partial(jax.jit, static_argnames=("max_iter",))
def communities(g: Graph, max_iter: int = 100) -> CommunitiesResult:
    n_pad = g.n_pad
    mask = g.node_mask()
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    comm0 = jnp.where(mask, ids, n_pad - 1)

    # CSR slots grouped by source: x counts labels of its out-neighbors
    e_src = g.node_idx_src.astype(jnp.int32)
    e_dst = g.node_idx.astype(jnp.int32)

    def real_step(state):
        comm, _ = state
        lbl = jnp.where(mask[e_dst] & (e_dst < g.num_nodes),
                        comm[e_dst], n_pad - 1)
        key = e_src * n_pad + lbl
        skey = jnp.sort(key)
        s_src = skey // n_pad
        s_lbl = skey % n_pad
        first = jnp.concatenate([jnp.ones((1,), bool),
                                 skey[1:] != skey[:-1]])
        # inclusive position within run, computed scatter-free:
        # pos_in_run[i] = i - last_start_at_or_before(i)
        idx = jnp.arange(skey.shape[0], dtype=jnp.int32)
        last_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(first, idx, -1))
        run_len_at = idx - last_start + 1
        # run's total count lives at its LAST element:
        last = jnp.concatenate([skey[1:] != skey[:-1],
                                jnp.ones((1,), bool)])
        # per (src): max (count, -label): encode cnt*n_pad + (n_pad-1-lbl)
        enc = jnp.where(last & (s_src < g.num_nodes)
                        & (s_lbl < n_pad - 1),
                        run_len_at * n_pad + (n_pad - 1 - s_lbl),
                        0)
        best = ops.sorted_segment_reduce(
            enc, s_src, g.begin, n_pad, "max")
        best_cnt = best // n_pad
        best_lbl = (n_pad - 1) - best % n_pad
        # HasMaxValue(x.Comm): keep current label if its count == max
        cur_enc = jnp.where(last & (s_src < g.num_nodes)
                            & (s_lbl == comm[jnp.clip(s_src, 0, n_pad - 1)]),
                            run_len_at, 0)
        cur_cnt = ops.sorted_segment_reduce(
            cur_enc, s_src, g.begin, n_pad, "max")
        take_new = (best_cnt > 0) & (cur_cnt < best_cnt)
        new = jnp.where(take_new & mask, best_lbl, comm)
        changed = jnp.any(new != comm)
        return new, ~changed

    def not_done(state):
        return ~state[1]

    (comm, _), stats = converge_loop(
        real_step, not_done, (comm0, jnp.asarray(False)), max_iter)
    return CommunitiesResult(comm=jnp.where(mask, comm, -1),
                             iterations=stats.iterations)


def communities_np(begin, node_idx, max_iter=100):
    """Host oracle with the same deterministic tie-break."""
    import numpy as np
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    comm = np.arange(N)
    for _ in range(max_iter):
        changed = False
        new = comm.copy()
        for x in range(N):
            nbrs = node_idx[begin[x]:begin[x + 1]]
            if len(nbrs) == 0:
                continue
            cnt = {}
            for y in nbrs:
                cnt[comm[y]] = cnt.get(comm[y], 0) + 1
            mx = max(cnt.values())
            if cnt.get(comm[x], 0) == mx:
                continue
            best = min(l for l, c in cnt.items() if c == mx)
            new[x] = best
            changed = True
        comm = new
        if not changed:
            break
    return comm
