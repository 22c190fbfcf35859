"""Random sampling / random-walk procedures.

Reimplements the reference sampling family with JAX counter-based RNG
(``runtime.rng``; the reference uses per-thread erand48/xorshift,
``gm_runtime.cc:60-75`` — stream identity differs, distributions match):

* ``random_node_sampling``      (``random_node_sampling.gm``)
* ``random_degree_node_sampling`` (``random_degree_node_sampling.gm``)
* ``random_walk_with_jump``     (``random_walk_sampling_with_random_jump.gm``)
* ``parallel_random_walks``     (``parallel_random_walk_jump_sampling.gm``
  -style: many walkers advanced in lockstep — the batched win)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..graph.csr import Graph
from ..runtime import rng as _rng


@jax.jit
def random_node_sampling(g: Graph, key, n: jax.Array) -> jax.Array:
    """S.Add(v) with prob 1/N each — returns [N_pad] bool set bitmap."""
    prob = 1.0 / n.astype(jnp.float32)
    dice = jax.random.uniform(key, (g.n_pad,))
    return (dice < prob) & g.node_mask()


@jax.jit
def random_degree_node_sampling(g: Graph, key, n: jax.Array) -> jax.Array:
    """Sample with prob proportional to out-degree (expected n picks)."""
    deg = g.out_degree().astype(jnp.float32)
    deg_sum = jnp.sum(jnp.where(g.node_mask(), deg, 0.0))
    prob = deg / jnp.maximum(deg_sum, 1.0) * n.astype(jnp.float32)
    dice = jax.random.uniform(key, (g.n_pad,))
    return (dice < prob) & g.node_mask()


@partial(jax.jit, static_argnames=("steps",))
def random_walk_with_jump(g: Graph, key, steps: int, c=0.15,
                          start: jax.Array | None = None) -> jax.Array:
    """Single walker, ``steps`` visits; jump to a uniform node with prob c
    or at dead ends.  Returns the visited-set bitmap [N_pad]."""
    k0, key = jax.random.split(key)
    cur = (start if start is not None
           else _rng.pick_random_nodes(k0, g)).astype(jnp.int32)
    visited0 = jnp.zeros((g.n_pad,), bool)

    def body(i, carry):
        cur, visited, key = carry
        visited = visited.at[cur].set(True)
        key, k1, k2, k3 = jax.random.split(key, 4)
        deg = g.begin[cur + 1] - g.begin[cur]
        jump = (deg == 0) | (jax.random.uniform(k1, ()) < c)
        nxt = jnp.where(jump,
                        _rng.pick_random_nodes(k2, g),
                        _rng.pick_random_nbr(k3, g, cur))
        return nxt.astype(jnp.int32), visited, key

    _, visited, _ = jax.lax.fori_loop(0, steps, body,
                                      (cur, visited0, key))
    return visited


@partial(jax.jit, static_argnames=("steps",))
def parallel_random_walks(g: Graph, key, starts: jax.Array, steps: int,
                          c=0.15) -> Tuple[jax.Array, jax.Array]:
    """W walkers in lockstep: returns (visit_counts [N_pad] int32,
    trajectory [steps, W] node ids).

    The lockstep batch replaces the reference's per-thread walkers
    (one RNG stream per walker, fully deterministic under any device
    count)."""
    W = starts.shape[0]
    cur0 = starts.astype(jnp.int32)

    def body(carry, i):
        cur, key = carry
        key, k1, k2, k3 = jax.random.split(key, 4)
        deg = g.begin[cur + 1] - g.begin[cur]
        jump = (deg == 0) | (jax.random.uniform(k1, (W,)) < c)
        nxt = jnp.where(jump,
                        _rng.pick_random_nodes(k2, g, (W,)),
                        _rng.pick_random_nbr(k3, g, cur))
        return (nxt.astype(jnp.int32), key), cur

    (_, _), traj = jax.lax.scan(body, (cur0, key),
                                jnp.arange(steps))
    counts = jax.ops.segment_sum(
        jnp.ones(traj.size, jnp.int32), traj.reshape(-1),
        num_segments=g.n_pad)
    return counts, traj


class MatchingResult(NamedTuple):
    match: jax.Array       # [N_pad] matched partner or -1
    count: jax.Array
    iterations: jax.Array


@partial(jax.jit, static_argnames=("max_iter",))
def random_bipartite_matching(g: Graph, is_left: jax.Array,
                              max_iter: int | None = None
                              ) -> MatchingResult:
    """``apps/src/random_bipartite_matching.gm``: repeated propose/accept
    rounds.  The reference's intended write-write race ("only one will
    make effect") becomes a deterministic min-id reduction: each unmatched
    right node accepts its smallest proposing left neighbor."""
    from ..engine.superstep import while_loop
    from ..ops import segment as ops
    if max_iter is None:
        max_iter = g.num_nodes + 1
    n_pad = g.n_pad
    mask = g.node_mask()
    NIL = jnp.int32(-1)
    big = jnp.iinfo(jnp.int32).max

    def step(state):
        match, _, count = state
        unmatched_left = is_left & (match == NIL) & mask
        unmatched_right = ~is_left & (match == NIL) & mask
        # proposals: left n -> every unmatched right neighbor t;
        # right accepts min proposer (pull over in-edges)
        src_ok = unmatched_left[g.r_node_idx]
        prop = jnp.where(src_ok, g.r_node_idx.astype(jnp.int32), big)
        suitor = ops.sorted_segment_reduce(
            prop, g.r_node_idx_dst, g.r_begin, n_pad, "min")
        suitor = jnp.where(unmatched_right & (suitor < big), suitor, NIL)
        # left accepts min replying right node
        # reply: right t chose suitor[t]; left n takes min t over replies
        ids = jnp.arange(n_pad, dtype=jnp.int32)
        # build per-left min over {t : suitor[t] == n}: reduce over edges
        # n->t: value t where suitor[t]==n
        tgt = g.node_idx
        reply = jnp.where(
            (suitor[tgt] == g.node_idx_src.astype(jnp.int32)) &
            (tgt < g.num_nodes),
            tgt.astype(jnp.int32), big)
        chosen = ops.sorted_segment_reduce(
            reply, g.node_idx_src, g.begin, n_pad, "min")
        has = unmatched_left & (chosen < big)
        new_match = jnp.where(has, chosen, match)
        new_match = new_match.at[jnp.where(has, chosen, n_pad - 1)].set(
            jnp.where(has, ids, new_match[jnp.clip(chosen, 0, n_pad - 1)]))
        added = jnp.sum(has.astype(jnp.int32))
        return new_match, added > 0, count + added

    def not_done(state):
        return state[1]

    state0 = (jnp.full((n_pad,), NIL), jnp.asarray(True),
              jnp.zeros((), jnp.int32))
    (match, _, count), stats = while_loop(step, not_done, state0, max_iter)
    return MatchingResult(match=jnp.where(mask, match, NIL), count=count,
                          iterations=stats.iterations)
