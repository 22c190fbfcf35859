"""Lowering of InBFS/InDFS statements (gm_grammer.y:266-304).

The reference compiles a BFS statement into a subclass of the
direction-optimizing ``gm_bfs_template`` with ``visit_fw``/``visit_rv``
virtuals (``gm_cpp_gen_bfs.cc:7-275``).  The JAX lowering instead:

1. computes the full level array with the framework's level-synchronous
   frontier engine (``models.hop_dist`` machinery);
2. replays the forward body once per level in a node context masked to
   that level's frontier (``UpNbrs``/``DownNbrs`` become level-filtered
   neighbor contexts);
3. replays the reverse body from the deepest level back to the root
   (``do_bfs_reverse``, gm_bfs_template.h:273).

The level count is data-dependent, so the per-level replay runs as a host
loop around jit-traced steps (level count is pulled to host once).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import gm_ast as A


def _levels(lw, root, transpose: bool, allowed=None):
    """Level array via iterative masked expansion (pure XLA).

    ``allowed`` is the navigator mask: nodes failing it are neither
    visited nor expanded (reference ``check_navigator``,
    gm_cpp_gen_bfs.cc — kosaraju prunes to the unassigned subgraph).
    Navigator state mutated *inside* the BFS body is not re-evaluated
    mid-traversal (same restriction the level-sync GPS lowering has).
    """
    from ..ops import segment as ops
    g = lw.g
    n_pad = g.n_pad
    INF = jnp.asarray(jnp.iinfo(jnp.int32).max, jnp.int32)
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    level = jnp.where(ids == root, 0, INF)
    mask = g.node_mask()
    if allowed is not None:
        mask = mask & allowed
        level = jnp.where(mask | (ids == root), level, INF)

    def cond(state):
        level, frontier_any, d = state
        return frontier_any

    def body(state):
        level, _, d = state
        fr = (level == d) & mask
        if transpose:
            # BFS over G^: v joins when some OUT-neighbor w (i.e. the
            # transposed edge w->v reversed) is in the frontier —
            # Exist(w: v.OutNbrs){fr[w]}.  (Was in_nbr_any — forward
            # expansion — which silently merged kosaraju's SCCs.)
            if lw.axis is None:
                from ..ops import scan_reduce
                reach = scan_reduce.out_nbr_count_true(g, fr) > 0
            else:
                # sharded slabs: g.begin is global, the slot arrays are
                # per-shard — reduce by the slab's src endpoints and
                # pcomb (offset-based prefix sums would misalign)
                from ..ops.segment import segment_max
                vals = fr[g.node_idx].astype(jnp.int8)
                reach = segment_max(vals, g.node_idx_src, g.n_pad,
                                    sorted_ids=False) > 0
        else:
            vals = fr[g.node_idx_src].astype(jnp.int8)
            from ..ops.segment import segment_max
            reach = segment_max(vals, g.node_idx, g.n_pad,
                                sorted_ids=False) > 0
        if lw.axis is not None:
            # sharded edge slabs: combine per-shard partial reach over
            # the mesh axis (the per-superstep message combine,
            # gm_gps_opt_transform_bfs.cc's level-sync form)
            reach = lw._pcomb(reach.astype(jnp.int8), "max") > 0
        newly = reach & (level == INF) & mask
        level2 = jnp.where(newly, d + 1, level)
        return level2, jnp.any(newly), d + 1

    level, _, depth = jax.lax.while_loop(
        cond, body, (level, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    return level, depth


def exec_bfs(lw, s: A.BFS, env, ctx):
    from .lower import LowerError, NodeCtx

    if ctx is not None:
        raise LowerError("InBFS nested inside a parallel loop")
    if not s.is_bfs:
        return exec_dfs(lw, s, env, ctx)
    g = lw.g
    root = lw._ident(s.root, env, None)
    allowed = None
    if s.navigator is not None:
        nav_ctx = NodeCtx(g=g, var=s.var,
                          ids=jnp.arange(g.n_pad, dtype=jnp.int32),
                          mask=g.node_mask())
        allowed = jnp.broadcast_to(
            jnp.asarray(lw.eval(s.navigator, env, nav_ctx)),
            (g.n_pad,)).astype(jnp.bool_)
    level, depth = _levels(lw, root, s.transpose, allowed)
    if lw.axis is not None or isinstance(depth, jax.core.Tracer):
        # under shard_map/jit everything is traced — no host level
        # count.  Replay levels inside traced fori loops (the reference
        # rewrites BFS into level-sync while loops before superstep
        # formation, gm_gps_opt_transform_bfs.cc).
        env["__bfs_level$" + s.var] = level
        _replay_traced(lw, s, env, level, depth)
        return
    depth = int(jax.device_get(depth))        # host sync: level count
    env["__bfs_level$" + s.var] = level

    ids = jnp.arange(g.n_pad, dtype=jnp.int32)
    base_mask = g.node_mask()

    def level_ctx(d):
        m = base_mask & (level == d)
        return NodeCtx(g=g, var=s.var, ids=ids, mask=m)

    # forward pass: shallow -> deep
    for d in range(depth + 1):
        nctx = level_ctx(d)
        if s.navigator is not None:
            nctx = nctx.with_mask(nctx.mask &
                                  lw.eval(s.navigator, env, nctx))
        if s.filter_fw is not None:
            nctx = nctx.with_mask(nctx.mask &
                                  lw.eval(s.filter_fw, env, nctx))
        lw._bfs_ctx = (s.var, level, d)
        try:
            lw._defer_stack.append((s.var, []))
            try:
                lw.exec_stmt(s.body_fw, env, nctx)
            finally:
                _, pend = lw._defer_stack.pop()
            for key, mask, val in pend:
                lw._wr(env, key, jnp.where(mask, val, env[key]))
        finally:
            lw._bfs_ctx = None

    _run_reverse(lw, s, env, level, depth, level_ctx)


def _replay_traced(lw, s, env, level, depth):
    """Forward + reverse level replay as traced ``fori_loop``s with
    body-written env entries as carries — the shard_map-compatible twin
    of the host per-level loops below (GPS transform_bfs analog)."""
    from .lower import (LowerError, NodeCtx, _DONE, _RET, _RNG,
                        declared_keys, uses_rng, written_keys)
    g = lw.g
    ids = jnp.arange(g.n_pad, dtype=jnp.int32)
    base_mask = g.node_mask()

    def run_phase(body, filt, reverse):
        if body is None:
            return
        wkeys = written_keys(body)
        if uses_rng(body):
            wkeys.add(_RNG)
            env.setdefault(_RNG, jnp.zeros((), jnp.uint32))
        carry_keys = sorted((wkeys - declared_keys(body))
                            - {_RET, _DONE})
        for k in carry_keys:
            if k not in env:
                raise LowerError(f"BFS body writes undeclared {k}")
        init = tuple(env[k] for k in carry_keys)
        dtypes = [jnp.asarray(v).dtype if isinstance(v, jax.Array)
                  else None for v in init]

        def body_fn(i, carry):
            d = (depth - i) if reverse else i
            e2 = dict(env)
            for k, v in zip(carry_keys, carry):
                e2[k] = v
            m = base_mask & (level == d)
            nctx = NodeCtx(g=g, var=s.var, ids=ids, mask=m)
            if s.navigator is not None and not reverse:
                nctx = nctx.with_mask(nctx.mask & jnp.broadcast_to(
                    jnp.asarray(lw.eval(s.navigator, e2, nctx)),
                    m.shape))
            if filt is not None:
                nctx = nctx.with_mask(nctx.mask & jnp.broadcast_to(
                    jnp.asarray(lw.eval(filt, e2, nctx)), m.shape))
            lw._bfs_ctx = (s.var, level, d)
            try:
                lw._defer_stack.append((s.var, []))
                try:
                    lw.exec_stmt(body, e2, nctx)
                finally:
                    _, pend = lw._defer_stack.pop()
                for key, mask, val in pend:
                    lw._wr(e2, key, jnp.where(mask, val, e2[key]))
            finally:
                lw._bfs_ctx = None
            out = []
            for k, dt in zip(carry_keys, dtypes):
                v = e2[k]
                out.append(jnp.asarray(v).astype(dt)
                           if dt is not None else v)
            return tuple(out)

        final = jax.lax.fori_loop(0, depth + 1, body_fn, init)
        for k, v in zip(carry_keys, final):
            env[k] = v

    run_phase(s.body_fw, s.filter_fw, False)
    run_phase(s.body_bw, s.filter_bw, True)


def _run_reverse(lw, s, env, level, depth, level_ctx):
    # reverse pass: deep -> shallow (InReverse body)
    if s.body_bw is not None:
        for d in range(depth, -1, -1):
            nctx = level_ctx(d)
            if s.filter_bw is not None:
                nctx = nctx.with_mask(nctx.mask &
                                      lw.eval(s.filter_bw, env, nctx))
            lw._bfs_ctx = (s.var, level, d)
            try:
                lw._defer_stack.append((s.var, []))
                try:
                    lw.exec_stmt(s.body_bw, env, nctx)
                finally:
                    _, pend = lw._defer_stack.pop()
                for key, mask, val in pend:
                    lw._wr(env, key, jnp.where(mask, val, env[key]))
            finally:
                lw._bfs_ctx = None


def exec_dfs(lw, s: A.BFS, env, ctx):
    """InDFS: host-sequential iterative DFS with pre/post visit bodies.

    The reference DFS template is sequential by design
    (``gm_dfs_template.h``, 187 LoC; select_par never parallelizes DFS
    bodies), so an eager host loop over the concrete CSR is the faithful
    lowering.  The navigator is checked at entry time with the *current*
    environment (kosaraju's ``[!n.Checked]`` prunes across restarts;
    tarjan's stack discipline mutates state mid-traversal).
    """
    import numpy as np

    from .lower import LowerError

    if ctx is not None:
        raise LowerError("InDFS nested inside a parallel loop")
    g = lw.g
    root = int(np.asarray(jax.device_get(lw._ident(s.root, env, None))))
    if s.transpose:
        begin = np.asarray(g.r_begin)
        ni = np.asarray(g.r_node_idx)
    else:
        begin = np.asarray(g.begin)
        ni = np.asarray(g.node_idx)
    visited = np.zeros(g.num_nodes, bool)
    stack = [(root, False)]
    while stack:
        v, post = stack.pop()
        env[s.var] = jnp.asarray(v, jnp.int32)
        if post:
            if s.filter_bw is not None and not bool(
                    np.asarray(jax.device_get(
                        lw.eval(s.filter_bw, env, None)))):
                continue
            if s.body_bw is not None:
                lw.exec_stmt(s.body_bw, env, None)
            continue
        if visited[v]:
            continue
        if s.navigator is not None and not bool(
                np.asarray(jax.device_get(
                    lw.eval(s.navigator, env, None)))):
            continue
        visited[v] = True
        stack.append((v, True))          # post-visit after children
        run_pre = True
        if s.filter_fw is not None:
            run_pre = bool(np.asarray(jax.device_get(
                lw.eval(s.filter_fw, env, None))))
        if run_pre and s.body_fw is not None:
            lw.exec_stmt(s.body_fw, env, None)
        for w in ni[begin[v]:begin[v + 1]][::-1]:
            if not visited[w]:
                stack.append((int(w), False))
    env.pop(s.var, None)
