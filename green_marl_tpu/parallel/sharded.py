"""Mesh-sharded execution: the Shoal + GPS/Giraph equivalent.

Reference mapping (SURVEY.md §2.10, §5):

* Shoal's per-array placement decisions — replicate read-only arrays,
  distribute O(E) arrays across NUMA domains
  (``scripts/run.sh:66-105,218-236``, ``gm_cpp_gen.cc:733-746``) — become
  sharding specs over a ``jax.sharding.Mesh``: edge arrays are
  range-sharded over the ``"v"`` axis, property/state arrays are
  replicated (round-1 scheme) or batch-sharded over ``"batch"``.
* The GPS/Giraph Pregel superstep machine (``gm_gps_gen_master.cc``)
  becomes a ``shard_map``-wrapped ``lax.while_loop``: every shard runs the
  same compiled superstep; the per-superstep "message exchange" is an XLA
  collective (``psum``/``pmax`` over the device interconnect), and "master scalars"
  (convergence ``diff``/``fin``) are computed replicated.

Edge partitioning is by equal CSC slot ranges (not vertex ranges), so
shards are edge-balanced by construction; a destination's in-edges may
straddle shards — partial segment reductions combine in the collective,
which is exactly the reduction tree the reference builds with per-thread
partials + combine (``gm_cpp_opt_reduce_scalar.cc``).

The batch axis shards whole algorithm instances (the reference has no
equivalent — one process per instance).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..graph.csr import Graph, round_up

INT32_MAX = jnp.iinfo(jnp.int32).max


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Edge-sharded view of a ``Graph``: [S, E_s] slabs of the CSC/CSR
    slot arrays (sentinel-padded), plus replicated O(N) offset arrays."""

    csc_src: jax.Array    # [S, E_s] source endpoint per CSC slot
    csc_dst: jax.Array    # [S, E_s] destination endpoint per CSC slot
    csc_eidx: jax.Array   # [S, E_s] CSR slot id (for edge properties)
    csr_src: jax.Array    # [S, E_s] source endpoint per CSR slot
    csr_dst: jax.Array    # [S, E_s] destination endpoint per CSR slot
    begin: jax.Array      # [N+1] replicated
    r_begin: jax.Array    # [N+1] replicated

    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    num_shards: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_pad(self) -> int:
        return round_up(self.num_nodes + 1)

    @property
    def sentinel(self) -> int:
        return self.num_nodes

    def node_mask(self) -> jax.Array:
        return jnp.arange(self.n_pad, dtype=jnp.int32) < self.num_nodes

    def out_degree(self) -> jax.Array:
        deg = self.begin[1:] - self.begin[:-1]
        return jnp.pad(deg, (0, self.n_pad - self.num_nodes - 1 + 1))


def shard_graph(g: Graph, num_shards: int) -> ShardedGraph:
    """Split the padded edge arrays into ``num_shards`` equal slabs
    (host-side, numpy)."""
    E_s = round_up(-(-g.e_pad // num_shards))
    total = E_s * num_shards
    sent = g.sentinel

    def slab(arr, fill):
        a = np.asarray(arr)
        out = np.full(total, fill, a.dtype)
        out[: a.shape[0]] = a
        return jnp.asarray(out.reshape(num_shards, E_s))

    return ShardedGraph(
        csc_src=slab(g.r_node_idx, sent),
        csc_dst=slab(g.r_node_idx_dst, sent),
        csc_eidx=slab(g.e_rev2idx, 0),
        csr_src=slab(g.node_idx_src, sent),
        csr_dst=slab(g.node_idx, sent),
        begin=g.begin,
        r_begin=g.r_begin,
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        num_shards=num_shards,
    )


def make_mesh(batch: int = 1, v: Optional[int] = None) -> Mesh:
    """Build a 2-D device mesh ``("batch", "v")``.

    ``batch`` shards whole algorithm instances (data-parallel analog);
    ``"v"`` shards the edge set (the Shoal distribute / GPS vertex-cut
    analog)."""
    devs = np.asarray(jax.devices())
    if v is None:
        v = devs.size // batch
    devs = devs[: batch * v].reshape(batch, v)
    return Mesh(devs, ("batch", "v"))


def place(sg: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """Device placement per the Shoal decision table: edge slabs
    distributed over "v", offset arrays replicated."""
    def put(arr, spec):
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return dataclasses.replace(
        sg,
        csc_src=put(sg.csc_src, P("v", None)),
        csc_dst=put(sg.csc_dst, P("v", None)),
        csc_eidx=put(sg.csc_eidx, P("v", None)),
        csr_src=put(sg.csr_src, P("v", None)),
        csr_dst=put(sg.csr_dst, P("v", None)),
        begin=put(sg.begin, P()),
        r_begin=put(sg.r_begin, P()),
    )


# ---------------------------------------------------------------------------
# Sharded algorithms
# ---------------------------------------------------------------------------

def pagerank_sharded(sg: ShardedGraph, mesh: Mesh, e=0.001, d=0.85,
                     max_iter: int = 100, dtype=jnp.float32):
    """PageRank over the mesh: local partial pull-sums per edge shard,
    combined with ``psum`` over "v" each superstep; rank is replicated
    (round-1 placement policy — the property-sharded variant arrives with
    the all-to-all exchange path)."""
    n = sg.num_nodes
    n_pad = sg.n_pad

    edge_specs = (P("v", None),) * 3
    rep = P()

    @partial(shard_map, mesh=mesh,
             in_specs=edge_specs + (rep, rep),
             out_specs=(rep, rep, rep), check_vma=False)
    def run(csc_src, csc_dst, csc_eidx, begin, r_begin):
        del csc_eidx, r_begin
        mask = jnp.arange(n_pad, dtype=jnp.int32) < n
        inv_n = jnp.asarray(1.0 / n, dtype)
        deg = jnp.pad(begin[1:] - begin[:-1],
                      (0, n_pad - n)).astype(dtype)
        inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1), 0.0)
        rank0 = jnp.where(mask, inv_n, 0).astype(dtype)
        src = csc_src.reshape(-1)
        dst = csc_dst.reshape(-1)

        def cond(carry):
            rank, diff, it = carry
            return jnp.logical_and(
                it < max_iter, jnp.logical_or(it == 0, diff > e))

        def body(carry):
            rank, _, it = carry
            contrib = rank * inv_deg
            part = jax.ops.segment_sum(contrib[src], dst,
                                       num_segments=n_pad,
                                       indices_are_sorted=True)
            s = jax.lax.psum(part, "v")
            val = (1 - d) * inv_n + d * s
            val = jnp.where(mask, val, 0)
            diff = jnp.sum(jnp.abs(val - rank))
            return val, diff, it + 1

        rank, diff, it = jax.lax.while_loop(
            cond, body, (rank0, jnp.zeros((), dtype), jnp.zeros((), jnp.int32)))
        return rank, diff, it

    return run(sg.csc_src, sg.csc_dst, sg.csc_eidx, sg.begin, sg.r_begin)


def multi_source_bfs_sharded(sg: ShardedGraph, mesh: Mesh,
                             roots: jax.Array, max_iter: int):
    """Batched BFS over the full 2-D mesh: instances sharded over "batch",
    edges over "v".  Per superstep: local edge-shard frontier expansion,
    ``pmax`` combine over "v"; global liveness via ``psum`` over "batch"."""
    n = sg.num_nodes
    n_pad = sg.n_pad

    @partial(shard_map, mesh=mesh,
             in_specs=(P("v", None), P("v", None), P("batch")),
             out_specs=(P(None, "batch"), P()), check_vma=False)
    def run(csc_src, csc_dst, roots_l):
        B_l = roots_l.shape[0]
        mask = jnp.arange(n_pad, dtype=jnp.int32) < n
        dist0 = jnp.full((n_pad, B_l), INT32_MAX, jnp.int32)
        dist0 = dist0.at[roots_l, jnp.arange(B_l)].set(0)
        dist0 = jnp.where(mask[:, None], dist0, INT32_MAX)
        src = csc_src.reshape(-1)
        dst = csc_dst.reshape(-1)

        def cond(carry):
            dist, depth, live = carry
            return jnp.logical_and(depth < max_iter, live > 0)

        def body(carry):
            dist, depth, _ = carry
            frontier = dist == depth
            part = jax.ops.segment_max(
                frontier[src].astype(jnp.int32), dst,
                num_segments=n_pad, indices_are_sorted=True)
            hit = jax.lax.pmax(part, "v") > 0
            newly = hit & (dist == INT32_MAX) & mask[:, None]
            dist = jnp.where(newly, depth + 1, dist)
            live_l = jnp.sum(newly.astype(jnp.int32))
            live = jax.lax.psum(live_l, "batch")
            return dist, depth + 1, live

        dist, depth, _ = jax.lax.while_loop(
            cond, body, (dist0, jnp.zeros((), jnp.int32),
                         jnp.ones((), jnp.int32)))
        return dist, depth

    return run(sg.csc_src, sg.csc_dst, roots)
