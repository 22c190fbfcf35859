"""Strongly-connected components (replaces kosaraju.gm / tarjan_scc.gm).

The reference implements Kosaraju's two-pass DFS (``apps/src/kosaraju.gm``)
and Tarjan's stack algorithm (``apps/src/tarjan_scc.gm``) — both
inherently sequential DFS formulations.  The device equivalent is the
**coloring / forward-backward** decomposition (Orzan; FW-BW of Fleischer
et al.), which is built entirely from fixpoint label propagations:

repeat until every node is assigned:
  1. color propagation: within unassigned nodes, propagate ``color[v] =
     max(color of forward-predecessors)`` to a fixpoint — every node ends
     with the max node id that can reach it (within unassigned);
  2. each color root r (``color[r] == r``) starts a *backward* reachability
     restricted to its own color; every node reached belongs to r's SCC
     (r reaches it forward via the color; it reaches r backward);
  3. assign those SCCs, remove them, repeat.

All rounds process every color in parallel; each superstep is a masked
edge map through the sorted-segment-reduce kernel.  Output: ``comp[v]`` =
SCC id canonicalized to the **minimum member node id** (the reference's
component numbering is traversal-order dependent; the partition is
identical, ids are normalized — documented semantic deviation).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops


class SCCResult(NamedTuple):
    comp: jax.Array        # [N_pad] int32, min member id per SCC; -1 pad
    rounds: jax.Array


@partial(jax.jit, static_argnames=("max_rounds",))
def scc(g: Graph, max_rounds: int | None = None) -> SCCResult:
    n_pad = g.n_pad
    mask = g.node_mask()
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    NONE = jnp.int32(-1)
    if max_rounds is None:
        max_rounds = g.num_nodes + 1

    def color_fixpoint(unassigned):
        color0 = jnp.where(unassigned, ids, NONE)

        def step(state):
            color, _ = state
            # pull: max over in-neighbors' colors (forward propagation)
            src_c = jnp.where(unassigned[g.r_node_idx],
                              color[g.r_node_idx], NONE)
            best = ops.sorted_segment_reduce(
                src_c, g.r_node_idx_dst, g.r_begin, n_pad, "max")
            new = jnp.where(unassigned, jnp.maximum(color, best), color)
            return new, jnp.any(new != color)

        def not_done(state):
            return state[1]

        (color, _), _ = while_loop(step, not_done,
                                   (color0, jnp.asarray(True)),
                                   max_rounds)
        return color

    def backward_within_color(color, unassigned):
        """Mark nodes backward-reachable from their color root within the
        color (all colors in parallel)."""
        member0 = unassigned & (color == ids)

        def step(state):
            member, _ = state
            # pull over *out*-edges: v joins if some out-neighbor w is a
            # member with the same color
            w_ok = member[g.node_idx] & (color[g.node_idx] ==
                                         color[g.node_idx_src])
            hit = ops.sorted_segment_reduce(
                w_ok.astype(jnp.int32), g.node_idx_src, g.begin,
                n_pad, "max") > 0
            new = member | (hit & unassigned)
            return new, jnp.any(new != member)

        def not_done(state):
            return state[1]

        (member, _), _ = while_loop(step, not_done,
                                    (member0, jnp.asarray(True)),
                                    max_rounds)
        return member

    def outer_step(state):
        comp, unassigned, rounds = state
        color = color_fixpoint(unassigned)
        member = backward_within_color(color, unassigned)
        comp = jnp.where(member, color, comp)
        unassigned = unassigned & ~member
        return comp, unassigned, rounds + 1

    def outer_not_done(state):
        return jnp.any(state[1])

    comp0 = jnp.full((n_pad,), NONE)
    (comp, _, rounds), _ = while_loop(
        outer_step, outer_not_done,
        (comp0, mask, jnp.zeros((), jnp.int32)), max_rounds)

    # canonicalize: comp id -> min member id (deterministic output)
    # min over members per color: scatter-free via sort would be ideal;
    # here a two-pass trick: rep[c] = min id whose comp == c, computed by
    # propagating through a segment reduce over a sorted permutation is
    # host-unfriendly inside jit — instead use comp-indexed min via
    # jnp .at[].min (cold path, runs once).
    rep = jnp.full((n_pad,), jnp.iinfo(jnp.int32).max, jnp.int32)
    rep = rep.at[jnp.where(mask, comp, n_pad - 1)].min(
        jnp.where(mask, ids, jnp.iinfo(jnp.int32).max))
    comp = jnp.where(mask, rep[jnp.clip(comp, 0, n_pad - 1)], NONE)
    return SCCResult(comp=comp, rounds=rounds)


def scc_np(begin, node_idx):
    """Host oracle: Tarjan (iterative), canonicalized to min member id."""
    import numpy as np
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    index = np.full(N, -1)
    low = np.zeros(N, dtype=np.int64)
    on_stack = np.zeros(N, bool)
    comp = np.full(N, -1)
    stack: list = []
    counter = [0]
    next_comp = [0]
    comp_members: list = []

    for root in range(N):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            row = node_idx[begin[v]:begin[v + 1]]
            for k in range(pi, len(row)):
                w = row[k]
                if index[w] == -1:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                members = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    members.append(w)
                    if w == v:
                        break
                comp_members.append(members)
                for m in members:
                    comp[m] = min(members)
            work.pop()
            if work:
                p, _ = work[-1]
                low[p] = min(low[p], low[v])
    return comp
