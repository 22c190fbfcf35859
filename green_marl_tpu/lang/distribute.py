"""Distributed execution of compiled Green-Marl programs over a mesh.

The JAX equivalent of the reference's GPS/Giraph distributed
backends (``src/backend_gps/``, SURVEY.md §2.6): there, the compiler carves
a procedure into supersteps and synthesizes typed messages between vertex
shards; here, the *same lowered program* runs SPMD under ``shard_map`` with

* edge arrays (CSR/CSC slot arrays + edge properties) **range-sharded**
  over a mesh axis (Shoal's array distribution, ``run.sh:66-105``),
* node properties and scalars **replicated** (GPS "master" state),
* every edge-space reduction finished with ``psum``/``pmin``/``pmax``
  over the axis (the per-superstep message combine) — inserted by
  ``Lowerer`` when constructed with ``axis=...``.

Feasibility rules mirror the reference's: random-access reads
(``HasEdgeTo``), BFS statements, and cross-layout edge-property access are
rejected (``gm_gps_new_check_random_read.cc``,
``gm_gps_opt_transform_bfs.cc``), with the same remedy — express the
algorithm as level-sync While supersteps, which all the bundled apps
already are.

Unlike the reference — whose distributed backends are compile-only tested
(``test/regression/test.py:157-158``) — this path is *executed* in CI on a
virtual 8-device CPU mesh (``tests/test_distribute.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # JAX >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..graph.csr import Graph, round_up
from .lower import CompiledProc

_EDGE_FIELDS = ("node_idx", "node_idx_src", "r_node_idx",
                "r_node_idx_dst", "e_rev2idx")
_NODE_FIELDS = ("begin", "r_begin")


def default_mesh(axis: str = "v",
                 n: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n is None:
        n = len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def pad_edges_for(g: Graph, num_shards: int) -> Graph:
    """Pad every [E_pad] array to a multiple of ``num_shards`` slabs
    (sentinel fill, harmless junk row) so each shard gets an equal slab."""
    e_pad = g.e_pad
    e_s = round_up(-(-e_pad // num_shards))
    tot = e_s * num_shards
    if tot == e_pad:
        return g
    fills = {"node_idx": g.num_nodes, "node_idx_src": g.num_nodes,
             "r_node_idx": g.num_nodes, "r_node_idx_dst": g.num_nodes,
             "e_rev2idx": 0}
    repl = {f: jnp.pad(getattr(g, f), (0, tot - e_pad),
                       constant_values=fills[f]) for f in _EDGE_FIELDS}
    return dataclasses.replace(g, **repl)


def run_sharded(cp: CompiledProc, g: Graph, *args,
                mesh: Optional[Mesh] = None, axis: str = "v",
                **kwargs) -> Dict:
    """Execute ``cp`` with edge arrays sharded over ``mesh[axis]``.

    Same call convention and results as ``cp(g, *args, **kwargs)``; node
    properties and scalars come back replicated, edge properties come
    back gathered to their global CSR slot order.
    """
    if mesh is None:
        mesh = default_mesh(axis)
    num_shards = mesh.shape[axis]
    g = pad_edges_for(g, num_shards)
    e_s = g.e_pad // num_shards

    # classify property args so edge props ride the sharded spec
    probe = CompiledProc(cp.proc)
    from .lower import Lowerer
    lw0 = Lowerer(cp.proc, g, axis=None)
    edge_kwargs = {k for k in kwargs
                   if k in lw0.props and lw0.props[k][0] == "E"}
    for k in edge_kwargs:
        arr = jnp.asarray(kwargs[k])
        if arr.shape[0] != g.e_pad:
            arr = jnp.pad(arr, (0, g.e_pad - arr.shape[0]))
        kwargs[k] = arr

    gspec = dataclasses.replace(
        g, **{f: P(axis) for f in _EDGE_FIELDS},
        **{f: P() for f in _NODE_FIELDS})

    arg_leaves = jax.tree.leaves((args, {k: v for k, v in kwargs.items()
                                         if k not in edge_kwargs}))
    plain_kwargs = {k: v for k, v in kwargs.items()
                    if k not in edge_kwargs}

    out_struct: Dict[str, str] = {}

    def body(gl: Graph, a, kw, ekw):
        e_base = jax.lax.axis_index(axis) * jnp.int32(e_s)
        gl = dataclasses.replace(gl, e_base=e_base)
        lw, env, out_names = cp._bind(gl, a, {**kw, **ekw}, axis=axis)
        lw.run(env)
        from .lower import _F, _RET
        outs = {}
        for name in out_names:
            v = env.get(_F + name, env.get(name))
            outs[name] = v
        if _RET in env:
            outs["_return"] = env[_RET]
        return outs

    # discover output names/kinds for out_specs
    out_names = []
    for decl in list(cp.proc.args) + list(cp.proc.out_args):
        for name in decl.names:
            if name in lw0.props:
                loc = lw0.props[name][0]
                out_struct[name] = loc

    def out_spec_of(name):
        if name == "_return":
            return P()
        loc = out_struct.get(name)
        return P(axis) if loc == "E" else P()

    # Trace once eagerly to learn which outputs exist, then build specs.
    # (cheap: abstract eval only)
    shape_eval = jax.eval_shape(
        lambda gg, a, kw, ekw: _single_device_outputs(
            cp, gg, a, kw, ekw),
        g, args, plain_kwargs, {k: kwargs[k] for k in edge_kwargs})
    out_specs = {k: out_spec_of(k) for k in shape_eval}

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(gspec, P(), P(), P(axis)),
        out_specs=out_specs,
        check_vma=False)
    out = fn(g, args, plain_kwargs, {k: kwargs[k] for k in edge_kwargs})
    return out


def _single_device_outputs(cp, g, a, kw, ekw):
    lw, env, out_names = cp._bind(g, a, {**kw, **ekw})
    from .lower import _F, _RET
    lw.run(env)
    outs = {}
    for name in out_names:
        outs[name] = env.get(_F + name, env.get(name))
    if _RET in env:
        outs["_return"] = env[_RET]
    return outs
