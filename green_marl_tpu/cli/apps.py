"""Per-algorithm CLI drivers (the generated ``*_main.cc`` equivalents).

Each app mirrors its reference main's arguments, defaults, and stdout
protocol: pagerank (``apps/output_cpp/src/pagerank_main.cc``:
``rank[%d] = %0.9lf``, defaults e=0.001 d=0.85 max=100), hop_dist
(``dist[%d] = %d``), triangle_counting (``number of triangles: %d``),
plus sssp / conductance / cc drivers on the same pattern.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np

from ..graph import binary_io as bio
from .usermain import (GM_EDGEPROP, GM_NODEPROP, GM_SCALAR, RunContext,
                       UserMain)


def _rng_root(ctx: RunContext) -> int:
    root = ctx.scalars.get("root", 0)
    return int(root) if root is not None else 0


def _num_chips(ctx: RunContext) -> int:
    """-GMNumChips: device count for the vertex-sharded path (the
    -GMNumThreads analog; reference common_main.h:29-230)."""
    k = ctx.options.get_option("GMNumChips") if ctx.options else None
    return int(k) if k else 1


def _placement(ctx: RunContext) -> str:
    p = (ctx.options.get_option("GMPlacement")
         if ctx.options else None) or "distribute"
    return p.lower()


def _placement_overrides(ctx: RunContext) -> Dict[str, str]:
    """Per-array placement overrides from -GMPlace / -GMPlacementFile
    (Shoal's local_array_settings.lua, run.sh:218-246)."""
    ov: Dict[str, str] = {}
    o = ctx.options
    if o is None:
        return ov
    f = o.get_option("GMPlacementFile")
    if f:
        import json
        try:
            with open(f) as fh:
                loaded = json.load(fh)
        except (OSError, ValueError) as e:
            raise SystemExit(f"-GMPlacementFile={f}: {e}")
        if not isinstance(loaded, dict):
            raise SystemExit(
                f"-GMPlacementFile={f}: expected a JSON object "
                "{\"arr\": \"policy\"}")
        ov.update({str(k): str(v) for k, v in loaded.items()})
    p = o.get_option("GMPlace")
    if p:
        for item in p.split(","):
            if ":" not in item:
                raise SystemExit(
                    f"-GMPlace expects arr:policy, got '{item}'")
            k, v = item.split(":", 1)
            ov[k.strip()] = v.strip()
    return ov


def _resolve_cp(gm_app):
    """App name (compiled from the reference sources) or an
    already-compiled ``CompiledProc`` (custom .gm mains)."""
    if isinstance(gm_app, str):
        from ..lang.lower import compile_file
        return compile_file(f"/root/reference/apps/src/{gm_app}.gm")
    return gm_app


def _no_overrides(ctx: RunContext, policy: str) -> None:
    """Per-array overrides only apply under the distribute policy —
    fail fast instead of silently ignoring the flag."""
    ov = _placement_overrides(ctx)
    if ov:
        raise SystemExit(
            f"-GMPlace/-GMPlacementFile overrides ({', '.join(ov)}) "
            f"apply only with -GMPlacement=distribute, not "
            f"'{policy}'")


def _run_replicated(ctx, gm_app, **kw):
    """-GMPlacement=replicate: compiled DSL program, edge arrays
    sharded, node state replicated + psum (the round-1 scheme, Shoal
    baseline config)."""
    from ..lang import distribute
    _no_overrides(ctx, "replicate")
    cp = _resolve_cp(gm_app)
    return distribute.run_sharded(cp, ctx.graph, **kw)


def _vsharded(ctx: RunContext, k: int):
    import jax

    from ..parallel import vertex_sharded as V
    _no_overrides(ctx, "engine")
    if len(jax.devices()) < k:
        raise SystemExit(
            f"-GMNumChips={k}: only {len(jax.devices())} devices "
            "(set XLA_FLAGS=--xla_force_host_platform_device_count "
            "for a virtual CPU mesh)")
    mesh = V.vmesh(k)
    vsg = V.place(V.build_vertex_sharded(ctx.graph, k), mesh)
    print(V.placement_report(vsg, mesh), file=sys.stderr)
    return vsg, mesh


def _run_compiled_vsharded(ctx: RunContext, gm_app: str, k: int, **kw):
    """-GMPlacement=distribute (default): COMPILED DSL program executed
    vertex-sharded — owned [N/S] node slabs + cut-sized ghost exchange
    inside the Lowerer itself (lang.lower_vertex), the GPS-backend
    capability.  ``engine`` selects the hand-written superstep engine,
    ``replicate`` the round-1 edge-sharding scheme."""
    import warnings as _w

    import jax

    from ..lang import lower_vertex as LV
    if len(jax.devices()) < k:
        raise SystemExit(
            f"-GMNumChips={k}: only {len(jax.devices())} devices "
            "(set XLA_FLAGS=--xla_force_host_platform_device_count "
            "for a virtual CPU mesh)")
    mesh = LV._default_mesh("v", k)
    sched = LV.place_schedule(LV.build_schedule(ctx.graph, k), mesh)
    from ..lang.lower import LowerError
    ov = _placement_overrides(ctx)
    print(LV.placement_report(sched, placements=ov), file=sys.stderr)
    cp = _resolve_cp(gm_app)
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        try:
            return LV.run_vertex_sharded(cp, ctx.graph, mesh=mesh,
                                         sched=sched, placements=ov,
                                         **kw)
        except LowerError as e:
            if ov:
                raise SystemExit(f"placement override error: {e}")
            raise


def make_pagerank() -> UserMain:
    m = UserMain("pagerank", "PageRank power iteration (pagerank.gm)")
    m.declare_scalar("max_iter", bio.GMTYPE_INT, True, False, default=100)
    m.declare_scalar("e", bio.GMTYPE_DOUBLE, True, False, default=0.001)
    m.declare_scalar("d", bio.GMTYPE_DOUBLE, True, False, default=0.85)
    m.declare_property("rank", bio.GMTYPE_DOUBLE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "replicate":
            import warnings as _w
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                out = _run_replicated(
                    ctx, "pagerank", e=float(ctx.scalars["e"]),
                    d=float(ctx.scalars["d"]),
                    max=int(ctx.scalars["max_iter"]))
            return {"rank": np.asarray(out["pg_rank"])}
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel.vertex_sharded import pagerank_vsharded
            vsg, mesh = _vsharded(ctx, k)
            rank, _, _ = pagerank_vsharded(
                vsg, mesh, e=float(ctx.scalars["e"]),
                d=float(ctx.scalars["d"]),
                max_iter=int(ctx.scalars["max_iter"]))
            return {"rank": np.asarray(rank)}
        if k > 1:
            out = _run_compiled_vsharded(
                ctx, "pagerank", k, e=float(ctx.scalars["e"]),
                d=float(ctx.scalars["d"]),
                max=int(ctx.scalars["max_iter"]))
            return {"rank": np.asarray(out["pg_rank"])}
        if ctx.options and ctx.options.get_option("GMProfile"):
            from ..utils.timing import graph_placement_report
            print(graph_placement_report(ctx.graph), file=sys.stderr)
            from ..models.pagerank import pagerank_profiled
            res = pagerank_profiled(
                ctx.graph, e=float(ctx.scalars["e"]),
                d=float(ctx.scalars["d"]),
                max_iter=int(ctx.scalars["max_iter"]))
            return {"rank": np.asarray(res.rank)}
        from ..models.pagerank import pagerank
        res = pagerank(ctx.graph, e=float(ctx.scalars["e"]),
                       d=float(ctx.scalars["d"]),
                       max_iter=int(ctx.scalars["max_iter"]))
        return {"rank": np.asarray(res.rank)}

    m.set_run(run)
    return m


def make_hop_dist() -> UserMain:
    m = UserMain("hop_dist", "Level-synchronous BFS distances (hop_dist.gm)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("dist", bio.GMTYPE_INT, False, True, GM_NODEPROP,
                       dump_count=10)  # hop_dist_main.cc prints dist[0..9]

    def run(ctx: RunContext) -> Dict:
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "replicate":
            import warnings as _w
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                out = _run_replicated(ctx, "hop_dist",
                                      root=_rng_root(ctx))
            return {"dist": np.asarray(out["dist"])}
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel.vertex_sharded import hop_dist_vsharded
            vsg, mesh = _vsharded(ctx, k)
            dist, _ = hop_dist_vsharded(vsg, mesh, _rng_root(ctx))
            # reference prints INT32_MAX for unreached (hop_dist.gm +INF)
            return {"dist": np.asarray(dist)}
        if k > 1:
            out = _run_compiled_vsharded(ctx, "hop_dist", k,
                                         root=_rng_root(ctx))
            return {"dist": np.asarray(out["dist"])}
        if ctx.options and ctx.options.get_option("GMProfile"):
            from ..models.relax import min_relax_profiled
            from ..utils.timing import graph_placement_report
            print(graph_placement_report(ctx.graph), file=sys.stderr)
            res = min_relax_profiled(ctx.graph, _rng_root(ctx))
            return {"dist": np.asarray(res.dist)}
        from ..models.hop_dist import hop_dist
        res = hop_dist(ctx.graph, _rng_root(ctx))
        return {"dist": np.asarray(res.dist)}

    m.set_run(run)
    return m


def make_sssp() -> UserMain:
    m = UserMain("sssp", "Bellman-Ford SSSP (sssp.gm)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)
    m.declare_property("dist", bio.GMTYPE_INT, False, True, GM_NODEPROP,
                       dump_count=10)  # hop_dist_main.cc prints dist[0..9]

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.sssp import sssp
        g = ctx.graph
        w = np.zeros(g.e_pad, np.int32)
        if "len" not in ctx.edge_props:
            # reference main generates lengths with its xorshift RNG
            # over CSR slots (sssp_main.cc:31-33) — replicate bit-exact;
            # cached on ctx so -GMMeasureTime's warmup pays for it (the
            # reference generates in prepare(), outside the timed region)
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
        w[: g.num_edges] = np.asarray(ctx.edge_props["len"])
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel import vertex_sharded as V
            vsg, mesh = _vsharded(ctx, k)
            w_slab = V.shard_edge_prop(vsg, g, w)
            dist, _ = V.sssp_vsharded(vsg, mesh, w_slab, _rng_root(ctx))
            return {"dist": np.asarray(dist)}
        if k > 1 and _placement(ctx) == "replicate":
            import warnings as _w
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                out = _run_replicated(ctx, "sssp", len=w,
                                      root=_rng_root(ctx))
            return {"dist": np.asarray(out["dist"])}
        if k > 1:
            out = _run_compiled_vsharded(ctx, "sssp", k, len=w,
                                         root=_rng_root(ctx))
            return {"dist": np.asarray(out["dist"])}
        if ctx.options and ctx.options.get_option("GMProfile"):
            from ..models.relax import min_relax_profiled
            res = min_relax_profiled(g, _rng_root(ctx),
                                     edge_len=jnp.asarray(w))
            return {"dist": np.asarray(res.dist)}
        res = sssp(g, _rng_root(ctx), jnp.asarray(w))
        return {"dist": np.asarray(res.dist)}

    m.set_run(run)
    return m


def make_triangle_counting() -> UserMain:
    m = UserMain("triangle_counting",
                 "Triangle counting, undirected (triangle_counting.gm)")
    m.declare_scalar("return", bio.GMTYPE_LONG, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.triangle import triangle_count_literal
        t = triangle_count_literal(ctx.graph)
        print(f"number of triangles: {t}")
        return {"return": t}

    m.set_run(run)
    return m


def make_conduct() -> UserMain:
    m = UserMain("conduct", "Conductance of a cut (conduct.gm)")
    m.declare_scalar("num", bio.GMTYPE_INT, True, False, default=1)
    m.declare_property("member", bio.GMTYPE_INT, True, False, GM_NODEPROP)
    m.declare_scalar("return", bio.GMTYPE_FLOAT, False, True)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.conductance import conductance
        g = ctx.graph
        member = np.zeros(g.n_pad, np.int32)
        if "member" in ctx.node_props:
            member[: g.num_nodes] = np.asarray(ctx.node_props["member"])
        k = _num_chips(ctx)
        if k > 1:
            # conduct.gm is a pure reduction program — the compiled
            # vertex-sharded path covers it (r4)
            out = _run_compiled_vsharded(ctx, "conduct", k,
                                         member=member,
                                         num=int(ctx.scalars["num"]))
            return {"return": float(out["_return"])}
        c = float(conductance(g, jnp.asarray(member),
                              int(ctx.scalars["num"])))
        return {"return": c}

    m.set_run(run)
    return m


def make_cc() -> UserMain:
    m = UserMain("weak_cc", "Weakly-connected components")
    m.declare_property("comp", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.cc import weak_cc
        res = weak_cc(ctx.graph)
        return {"comp": np.asarray(res.comp)}

    m.set_run(run)
    return m


def make_conduct_main() -> UserMain:
    """conduct_main.cc protocol: xorshift 10/20/30/40% membership,
    sum of conductance over the 4 cuts, ``sum C = %lf``."""
    m = UserMain("conduct_main", "Sum of conductances over 4 random "
                 "cuts (conduct_main.cc)")
    m.declare_scalar("return", bio.GMTYPE_DOUBLE, False, True)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.conductance import conductance
        from ..utils.gm_rand import conduct_membership
        g = ctx.graph
        if "__member" not in ctx.node_props:
            m = np.zeros(g.n_pad, np.int32)
            m[: g.num_nodes] = conduct_membership(g.num_nodes)
            ctx.node_props["__member"] = m
        mj = jnp.asarray(ctx.node_props["__member"])
        c = sum(float(conductance(g, mj, i)) for i in range(4))
        print(f"sum C = {c:f}")
        return {"return": c}

    m.set_run(run)
    return m


def make_avg_teen_cnt() -> UserMain:
    m = UserMain("avg_teen_cnt", "Average teen count (avg_teen_cnt.gm; "
                 "main sets age=10, K=5)")
    m.declare_scalar("K", bio.GMTYPE_INT, True, False, default=5)
    m.declare_scalar("return", bio.GMTYPE_FLOAT, False, True)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.analytics import avg_teen_cnt
        g = ctx.graph
        age = jnp.full((g.n_pad,), 10, jnp.int32)
        k = _num_chips(ctx)
        if k > 1:
            out = _run_compiled_vsharded(
                ctx, "avg_teen_cnt", k, K=int(ctx.scalars["K"]),
                age=np.asarray(age))
            avg = float(out["_return"])
        else:
            avg, _ = avg_teen_cnt(g, age, int(ctx.scalars["K"]))
        print(f"avg = {float(avg):0.9f}")
        return {"return": float(avg)}

    m.set_run(run)
    return m


def make_bc() -> UserMain:
    m = UserMain("bc", "Betweenness centrality, random seeds "
                 "(bc_random_main.cc pattern)")
    m.declare_scalar("num_seeds", bio.GMTYPE_INT, True, False, default=4)
    m.declare_property("BC", bio.GMTYPE_FLOAT, False, True, GM_NODEPROP,
                       dump_count=4)   # bc_main.cc prints BC[0..3]

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.bc import bc
        g = ctx.graph
        k = int(ctx.scalars["num_seeds"])
        seeds = jnp.asarray(np.arange(k) % g.num_nodes, jnp.int32)
        res = bc(g, seeds)
        return {"BC": np.asarray(res.bc)}

    m.set_run(run)
    return m


def make_sssp_path() -> UserMain:
    m = UserMain("sssp_path", "SSSP with path reconstruction "
                 "(sssp_path_main.cc)")
    m.declare_scalar("begin", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("end", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.sssp_path import get_path, sssp_path
        g = ctx.graph
        w = np.zeros(g.e_pad, np.int32)
        if "len" not in ctx.edge_props:
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
        w[: g.num_edges] = np.asarray(ctx.edge_props["len"])
        b = int(ctx.scalars["begin"])
        e = int(ctx.scalars["end"])
        res = sssp_path(g, b, jnp.asarray(w))
        path = get_path(np.asarray(res.prev), b, e)
        print(f"shortest path from {b} to {e}")
        print(" -> ".join(str(n) for n in path) if path else "NO_PATH")
        return {}

    m.set_run(run)
    return m


def make_scc(name="kosaraju") -> UserMain:
    m = UserMain(name, "Strongly connected components "
                 "(kosaraju_main.cc protocol)")
    m.declare_property("mem", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        if name == "tarjan_scc" and ctx.graph.num_nodes <= 100_000:
            # the reference tarjan_scc.gm is NOT exact Tarjan (its
            # post-visit LowLink fold reads popped neighbors); run the
            # DSL program literally so output matches the reference app.
            # Beyond the host-DFS scale cap the device forward-backward
            # SCC below takes over (identical partition, normalized ids
            # — documented deviation, like kosaraju's routing).
            import os
            import warnings as _w
            path = "/root/reference/apps/src/tarjan_scc.gm"
            if os.path.exists(path):
                from ..lang.lower import compile_file
                with _w.catch_warnings():
                    _w.simplefilter("ignore")
                    out = compile_file(path)(ctx.graph)
                mem = np.asarray(out["SCC"])[: ctx.graph.num_nodes]
                print(f"num_membership = {len(np.unique(mem))}")
                return {"mem": np.asarray(out["SCC"])}
        from ..models.scc import scc
        res = scc(ctx.graph)
        mem = np.asarray(res.comp)[: ctx.graph.num_nodes]
        print(f"num_membership = {len(np.unique(mem))}")
        return {"mem": np.asarray(res.comp)}

    m.set_run(run)
    return m


def make_v_cover() -> UserMain:
    m = UserMain("v_cover", "Vertex cover (v_cover_main.cc)")
    m.declare_property("select", bio.GMTYPE_BOOL, False, True,
                       GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.v_cover import v_cover
        res = v_cover(ctx.graph)
        print(f"covered (may be non-deterministic) = {int(res.count)}")
        return {"select": np.asarray(res.select)}

    m.set_run(run)
    return m


def make_communities() -> UserMain:
    m = UserMain("communities", "Label propagation "
                 "(communities_main.cc)")
    m.declare_property("Comm", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.communities import communities
        res = communities(ctx.graph)
        comm = np.asarray(res.comm)[: ctx.graph.num_nodes]
        ids, cnt = np.unique(comm, return_counts=True)
        print("Community\t#Nodes\t\t(showing max 10 entries)")
        for i, c in list(zip(ids, cnt))[:10]:
            print(f"{i}\t\t{c}")
        return {"Comm": np.asarray(res.comm)}

    m.set_run(run)
    return m


def _make_sampling(name: str) -> UserMain:
    m = UserMain(name, f"{name} (sampling family; RNG is the "
                 "framework's counter-based threefry, not the "
                 "reference xorshift — outputs are distributional)")
    m.declare_scalar("n", bio.GMTYPE_INT, True, False, default=100)
    m.declare_property("sampled", bio.GMTYPE_BOOL, False, True,
                       GM_NODEPROP, dump_count=0)

    def run(ctx: RunContext) -> Dict:
        import jax
        import jax.numpy as jnp
        from ..models import sampling as S
        g = ctx.graph
        key = jax.random.PRNGKey(0)
        n = jnp.asarray(int(ctx.scalars["n"]), jnp.int32)
        if name == "random_node_sampling":
            out = S.random_node_sampling(g, key, n)
        elif name == "random_degree_node_sampling":
            out = S.random_degree_node_sampling(g, key, n)
        else:
            out = S.random_walk_with_jump(g, key, steps=int(n))
        return {"sampled": np.asarray(out).astype(np.bool_)}

    m.set_run(run)
    return m


def make_random_node_sampling() -> UserMain:
    return _make_sampling("random_node_sampling")


def make_random_degree_node_sampling() -> UserMain:
    return _make_sampling("random_degree_node_sampling")


def make_random_walk_sampling() -> UserMain:
    return _make_sampling("random_walk_sampling_with_random_jump")


def make_random_bipartite_matching() -> UserMain:
    m = UserMain("random_bipartite_matching",
                 "Parallel maximal bipartite matching")
    m.declare_property("isLeft", bio.GMTYPE_BOOL, True, False,
                       GM_NODEPROP)
    m.declare_scalar("return", bio.GMTYPE_INT, False, True)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.sampling import random_bipartite_matching
        g = ctx.graph
        left = np.zeros(g.n_pad, bool)
        if "isLeft" in ctx.node_props:
            left[: g.num_nodes] = np.asarray(
                ctx.node_props["isLeft"]).astype(bool)
        else:
            # no property supplied: sources with out-edges are "left"
            left[: g.num_nodes] = (np.diff(np.asarray(g.begin)) > 0)
        res = random_bipartite_matching(g, jnp.asarray(left))
        print(f"matched = {int(res.count)}")
        return {"return": int(res.count)}

    m.set_run(run)
    return m


def make_sssp_dijkstra() -> UserMain:
    m = UserMain("sssp_dijkstra", "Dijkstra-class SSSP (delta-stepping "
                 "reformulation; sssp_dijkstra_main.cc)")
    m.declare_scalar("src", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("dst", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        from ..models.delta_stepping import delta_stepping
        g = ctx.graph
        w = np.zeros(g.e_pad, np.int32)
        if "len" not in ctx.edge_props:
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
        w[: g.num_edges] = np.asarray(ctx.edge_props["len"])
        res = delta_stepping(g, int(ctx.scalars["src"]),
                             jnp.asarray(w))
        d = np.asarray(res.dist)
        dst = int(ctx.scalars["dst"])
        cost = int(d[dst])
        if cost >= np.iinfo(np.int32).max // 2:
            print("weight   -1 ,hops  -1, path=NO_PATH_EXISTS")
        else:
            print(f"weight {cost:4d} ,hops  -1, path=FOUND")
        return {}

    m.set_run(run)
    return m


def make_potential_friends() -> UserMain:
    m = UserMain("potential_friends", "Friend-of-friend candidates "
                 "(potential_friends.gm; bit-matrix set property)")
    m.declare_scalar("return", bio.GMTYPE_LONG, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.analytics import potential_friends
        pf = np.asarray(potential_friends(ctx.graph))
        n = ctx.graph.num_nodes
        total = int(pf[:n, :n].sum())
        print(f"potential friend pairs = {total}")
        return {"return": total}

    m.set_run(run)
    return m


def make_multi_bfs() -> UserMain:
    m = UserMain("multi_bfs", "Batched multi-source BFS on the "
                 "bit-packed binned engine (the capability the "
                 "reference lacks; SURVEY.md §2.10)")
    m.declare_scalar("num_roots", bio.GMTYPE_INT, True, False,
                     default=1024)
    m.declare_scalar("plane_bits", bio.GMTYPE_INT, True, False,
                     default=32)

    def run(ctx: RunContext) -> Dict:
        import time

        import jax
        import jax.numpy as jnp

        from ..models import batched
        from ..ops import binned
        g = ctx.graph
        B = int(ctx.scalars["num_roots"])
        pb = int(ctx.scalars["plane_bits"])
        if pb not in (8, 16, 32):
            raise SystemExit("plane_bits must be 8, 16 or 32")
        if B > 128 * pb:
            raise SystemExit(f"num_roots <= {128 * pb} at "
                             f"plane_bits={pb}")
        bp = binned.device_put_lite(binned.binned_in(g))
        deg = np.asarray(g.out_degree())[: bp.n_nodes]
        deg_rows = np.zeros(bp.n_rows, np.int32)
        deg_rows[: bp.n_nodes] = deg[np.asarray(bp.perm)]
        deg_rows = jax.device_put(deg_rows)
        order = np.argsort(np.asarray(g.out_degree())[: g.num_nodes])
        roots = order[::-1][:B].astype(np.int32)
        t0 = time.time()
        res = batched.multi_source_bfs_bits(
            bp, jnp.asarray(roots), deg_rows, plane_bits=pb)
        trav = np.asarray(jax.device_get(res.traversed)).astype(np.int64)
        dt = time.time() - t0
        total = int(trav.sum())
        print(f"batched bfs: B={B} levels={int(res.levels_run)} "
              f"traversed={total} "
              f"aggregate={total / dt / 1e9:.3f} GTEPS "
              "(incl. compile on first run)")
        return {}

    m.set_run(run)
    return m


def make_adamic_adar() -> UserMain:
    m = UserMain("adamicAdar", "Adamic-Adar edge scores "
                 "(adamicAdar_main.cc: '%d-> %5.5f' lines)")
    m.declare_property("aa", bio.GMTYPE_DOUBLE, False, True, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        import warnings as _w
        from ..lang.lower import compile_file
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            out = compile_file(
                "/root/reference/apps/src/adamicAdar.gm")(ctx.graph)
        aa = np.asarray(out["aa"])[: ctx.graph.num_edges]
        for i in range(min(10, aa.shape[0])):     # reference prints all
            print(f"{i}-> {aa[i]:5.5f}")
        return {"aa": np.asarray(out["aa"])}

    m.set_run(run)
    return m


def make_b2() -> UserMain:
    m = UserMain("b2", "DFS pre/post-order smoke (b2_main.cc: timing "
                 "only)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("A", bio.GMTYPE_INT, False, True, GM_NODEPROP)
    m.declare_property("B", bio.GMTYPE_INT, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        import warnings as _w
        from ..lang.lower import compile_file
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            out = compile_file("/root/reference/apps/src/b2.gm")(
                ctx.graph, s=_rng_root(ctx))
        outs = {}
        for k in ("A", "B"):
            if k in out:
                outs[k] = np.asarray(out[k])
        return outs

    m.set_run(run)
    return m


def make_bc_variant(name: str) -> UserMain:
    """bc_adj (adjacency-list input) / bc_random (xorshift seeds) —
    same kernel as bc, different loader default / seed policy."""
    m = UserMain(name, f"Betweenness centrality ({name}_main.cc)")
    m.declare_scalar("num_seeds", bio.GMTYPE_INT, True, False, default=4)
    m.declare_property("BC", bio.GMTYPE_FLOAT, False, True, GM_NODEPROP,
                       dump_count=4)   # prints BC[0..3]
    if name == "bc_adj":
        # adjacency-list input is this main's native format
        m.O.add_option("GMInputFormat", str, "ADJ",
                       "input format (default ADJ for this main)")

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp

        from ..models.bc import bc
        g = ctx.graph
        k = int(ctx.scalars["num_seeds"])
        if name == "bc_random":
            # deterministic xorshift stream (gm_rand), like the
            # reference's rand-seeded variant but reproducible
            from ..utils.gm_rand import GmRand32
            seeds = jnp.asarray(
                GmRand32().sequence(k) % np.uint64(g.num_nodes),
                jnp.int32)
        else:
            seeds = jnp.asarray(np.arange(k) % g.num_nodes, jnp.int32)
        res = bc(g, seeds)
        return {"BC": np.asarray(res.bc)}

    m.set_run(run)
    return m


def make_bidir_dijkstra() -> UserMain:
    m = UserMain("bidir_dijkstra", "Bidirectional Dijkstra "
                 "(bidir_dijkstra_main.cc: 'weight .. path=' line)")
    m.declare_scalar("src", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("dst", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("Weight", bio.GMTYPE_INT, True, False,
                       GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp
        g = ctx.graph
        w = np.zeros(g.e_pad, np.int32)
        if "Weight" not in ctx.edge_props:
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["Weight"] = sssp_edge_lengths(g.num_edges)
        w[: g.num_edges] = np.asarray(ctx.edge_props["Weight"])
        s = int(ctx.scalars["src"])
        t = int(ctx.scalars["dst"])
        gm_path = "/root/reference/apps/src/bidir_dijkstra.gm"
        if os.path.exists(gm_path):
            # literal DSL program — the round-5 idiom recognizer lowers
            # the two-map pop-min loop to forward+reverse device
            # Bellman-Ford (lang/lower_priority.try_bidir_while), so the
            # old 100k host-eager scale cap is gone
            import warnings as _w
            from ..lang.lower import compile_file
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                out = compile_file(gm_path)(g, Weight=w, src=s, dst=t)
            found = bool(out["_return"])
            par = np.asarray(out["Parent"])[: g.num_nodes]
            pare = np.asarray(out["ParentEdge"])[: g.num_nodes]
        else:
            # scale path: forward+reverse device Bellman-Ford, meet at
            # the min-total node, stitch parent chains (documented
            # deviation: tie-breaking)
            from ..models.sssp_path import sssp_path
            gt, _ = __import__(
                "green_marl_tpu.graph.csr", fromlist=["from_edges"]
            ).from_edges(np.asarray(g.node_idx)[: g.num_edges],
                         np.asarray(g.node_idx_src)[: g.num_edges],
                         g.num_nodes)
            wv = jnp.asarray(w)
            rf = sssp_path(g, s, wv)
            wr = np.zeros(gt.e_pad, np.int32)
            wr[: g.num_edges] = np.asarray(
                w[: g.num_edges])[np.asarray(g.e_rev2idx)[: g.num_edges]]
            rb = sssp_path(gt, t, jnp.asarray(wr))
            BIG = np.int64(np.iinfo(np.int32).max)
            df = np.asarray(rf.dist)[: g.num_nodes].astype(np.int64)
            db_ = np.asarray(rb.dist)[: g.num_nodes].astype(np.int64)
            tot = np.where((df < BIG) & (db_ < BIG), df + db_, BIG)
            mid = int(np.argmin(tot))
            found = bool(tot[mid] < BIG)
            par = np.full(g.num_nodes, -1, np.int64)
            pare = np.full(g.num_nodes, -1, np.int64)
            if found:
                pf = np.asarray(rf.prev)[: g.num_nodes]
                pb = np.asarray(rb.prev)[: g.num_nodes]
                cur = mid
                while cur != s and pf[cur] >= 0:
                    par[cur] = pf[cur]
                    cur = int(pf[cur])
                cur = mid
                while cur != t and pb[cur] >= 0:
                    par[int(pb[cur])] = cur
                    cur = int(pb[cur])
        if not found:
            print("weight %4d ,hops %3d, time %7.2f path=%s"
                  % (0, -1, 0.0, "NO_PATH_EXISTS"))
            return {}
        # walk dst -> src through Parent, print src -> dst order
        path = [t]
        seen = set()
        cur = t
        while cur != s and par[cur] >= 0 and cur not in seen:
            seen.add(cur)
            cur = int(par[cur])
            path.append(cur)
        path.reverse()
        ecost = {}
        s_ = np.asarray(g.node_idx_src)[: g.num_edges]
        d_ = np.asarray(g.node_idx)[: g.num_edges]
        for i in range(g.num_edges):
            k2 = (int(s_[i]), int(d_[i]))
            ecost[k2] = min(ecost.get(k2, 1 << 30), int(w[i]))
        weight = sum(ecost.get((a, b), 0)
                     for a, b in zip(path[:-1], path[1:]))
        print("weight %4d ,hops %3d, time %7.2f path="
              % (weight, len(path), 0.0)
              + "".join(f"v{n}=>" for n in path))
        return {}

    m.set_run(run)
    return m


def make_sssp_path_adj() -> UserMain:
    m = UserMain("sssp_path_adj", "SSSP path, adjacency-list input "
                 "(sssp_path_adj_main.cc protocol)")
    m.declare_scalar("begin", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("end", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)
    # adjacency-list input is this main's native format
    m.O.add_option("GMInputFormat", str, "ADJ",
                   "input format (default ADJ for this main)")

    def run(ctx: RunContext) -> Dict:
        import jax.numpy as jnp

        from ..models.sssp_path import get_path, sssp_path
        g = ctx.graph
        w = np.zeros(g.e_pad, np.int32)
        if "len" not in ctx.edge_props:
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
        w[: g.num_edges] = np.asarray(ctx.edge_props["len"])
        b = int(ctx.scalars["begin"])
        e = int(ctx.scalars["end"])
        res = sssp_path(g, b, jnp.asarray(w))
        path = get_path(np.asarray(res.prev), b, e)
        if not path:
            print("PATH NOT FOUND")
            return {}
        print(f"{b} -> {e}")
        dist = np.asarray(res.dist)[: g.num_nodes]
        print(f"    Costs are {float(dist[e]):f}")
        print(f"    Number of links is {max(len(path) - 1, 0)}")
        return {}

    m.set_run(run)
    return m


APPS = {
    "pagerank": make_pagerank,
    "adamicAdar": make_adamic_adar,
    "b2": make_b2,
    "bc_adj": lambda: make_bc_variant("bc_adj"),
    "bc_random": lambda: make_bc_variant("bc_random"),
    "bidir_dijkstra": make_bidir_dijkstra,
    "sssp_path_adj": make_sssp_path_adj,
    "multi_bfs": make_multi_bfs,
    "hop_dist": make_hop_dist,
    "sssp": make_sssp,
    "triangle_counting": make_triangle_counting,
    "conduct": make_conduct,
    "conduct_main": make_conduct_main,
    "weak_cc": make_cc,
    "avg_teen_cnt": make_avg_teen_cnt,
    "bc": make_bc,
    "sssp_path": make_sssp_path,
    "kosaraju": make_scc,
    "tarjan_scc": lambda: make_scc("tarjan_scc"),
    "v_cover": make_v_cover,
    "communities": make_communities,
    "random_node_sampling": make_random_node_sampling,
    "random_degree_node_sampling": make_random_degree_node_sampling,
    "random_walk_sampling_with_random_jump": make_random_walk_sampling,
    "random_bipartite_matching": make_random_bipartite_matching,
    "sssp_dijkstra": make_sssp_dijkstra,
    "potential_friends": make_potential_friends,
}


_GM_PRIM2BIO = {
    "BOOL": bio.GMTYPE_BOOL, "INT": bio.GMTYPE_INT,
    "LONG": bio.GMTYPE_LONG, "FLOAT": bio.GMTYPE_FLOAT,
    "DOUBLE": bio.GMTYPE_DOUBLE, "NODE": bio.GMTYPE_NODE,
    "EDGE": bio.GMTYPE_EDGE,
}


def make_custom(path: str) -> UserMain:
    """``gm_default_usermain`` analog for an ARBITRARY ``.gm`` file:
    the procedure's declared schema becomes the CLI — scalar inputs
    turn into flags, input properties load from the graph file (EBIN/
    AVRO), output properties/return print through the stdout protocol
    and store with ``-GMDumpGraph`` — exactly what the reference
    generates with ``-CppMain`` (``gm_default_usermain.cc:123``
    auto-registers procedure args as options).  ``-GMNumChips`` routes
    through the compiled vertex-sharded lowering like registered apps.
    Collection/map arguments are not CLI-bindable; use the library API
    (``compile_file(path)(g, ...)``) for those."""
    from ..lang.lower import compile_file
    cp = compile_file(path)
    proc = cp.proc
    m = UserMain(proc.name,
                 f"{proc.name} (compiled from {os.path.basename(path)})")
    in_scalars, in_props, out_props, skipped = [], [], [], []
    for decl in proc.args:
        t = decl.type
        for nm in decl.names:
            if t.kind == "GRAPH":
                continue
            if t.is_property():
                bt = _GM_PRIM2BIO.get(getattr(t.elem, "kind", None),
                                      bio.GMTYPE_DOUBLE)
                kind = GM_NODEPROP if t.kind == "NODEPROP" \
                    else GM_EDGEPROP
                m.declare_property(nm, bt, True, False, kind)
                in_props.append((nm, kind))
            elif t.kind in _GM_PRIM2BIO:
                m.declare_scalar(nm, _GM_PRIM2BIO[t.kind], True, False,
                                 default=0)
                in_scalars.append(nm)
            else:
                skipped.append(nm)
    for decl in proc.out_args:
        t = decl.type
        for nm in decl.names:
            if t.is_property():
                bt = _GM_PRIM2BIO.get(getattr(t.elem, "kind", None),
                                      bio.GMTYPE_DOUBLE)
                kind = GM_NODEPROP if t.kind == "NODEPROP" \
                    else GM_EDGEPROP
                m.declare_property(nm, bt, False, True, kind)
                out_props.append(nm)
            elif t.kind in _GM_PRIM2BIO:
                m.declare_scalar(nm, _GM_PRIM2BIO[t.kind], False, True)
                out_props.append(nm)
    rt = proc.return_type
    if rt is not None and rt.kind in _GM_PRIM2BIO:
        m.declare_scalar("return", _GM_PRIM2BIO[rt.kind], False, True)
    if skipped:
        print(f"# note: collection/map args {skipped} are not "
              "CLI-bindable; pass them via the library API",
              file=sys.stderr)

    def run(ctx: RunContext) -> Dict:
        kw = {}
        for nm in in_scalars:
            v = ctx.scalars.get(nm)
            if v is not None:
                kw[nm] = v
        g = ctx.graph
        for nm, kind in in_props:
            src = (ctx.node_props if kind == GM_NODEPROP
                   else ctx.edge_props)
            if nm not in src:
                # gm_default_usermain.cc:419 do_preprocess fails the
                # run when a declared input property cannot be loaded
                # from the graph file; a silent skip would compute
                # against an unbound (zero) property.
                k = ("node" if kind == GM_NODEPROP else "edge")
                have = sorted(src) or ["<none>"]
                raise SystemExit(
                    f"error: declared input {k} property '{nm}' is "
                    f"not present in the graph file (loaded {k} "
                    f"properties: {', '.join(have)}). Input "
                    "properties load only from formats that carry "
                    "them: EBIN (-GMInputFormat=ebin), AVRO, or a "
                    "typed EDGE list - plain BIN/ADJ files have "
                    "none.")
            a = np.asarray(src[nm])
            # compiled binding takes padded arrays (apps pad
            # themselves, lower._bind does not)
            pad_n = g.n_pad if kind == GM_NODEPROP else g.e_pad
            padded = np.zeros(pad_n, a.dtype)
            padded[: a.shape[0]] = a
            kw[nm] = padded
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "replicate":
            out = _run_replicated(ctx, cp, **kw)
        elif k > 1:
            out = _run_compiled_vsharded(ctx, cp, k, **kw)
        else:
            out = cp(g, **kw)
        res = {nm: np.asarray(out[nm]) for nm in out_props
               if nm in out}
        if "_return" in out:
            res["return"] = out["_return"]
        return res

    m.set_run(run)
    return m


def main(argv=None) -> int:
    from ..utils import compile_cache
    compile_cache.enable()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m green_marl_tpu.cli.run "
              "<app | file.gm> [options] <graph> [output]")
        print("apps: " + ", ".join(sorted(APPS)))
        return 1
    app = argv[0]
    if app not in APPS:
        if app.endswith(".gm") and os.path.exists(app):
            return make_custom(app).main(argv[1:])
        print(f"unknown app '{app}'; available: {', '.join(sorted(APPS))}"
              " (or a path to a .gm file)",
              file=sys.stderr)
        return 1
    return APPS[app]().main(argv[1:])
