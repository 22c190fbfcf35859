"""Vertex-sharded execution: owned node state is O(N/S) per device.

This is the JAX equivalent of the reference's *actual* distributed
capability — GPS/Giraph vertex partitioning with typed per-superstep
messages (``src/inc/gps_comminfo.h:8-100``,
``src/backend_gps/gm_gps_find_congruent_message.cc``) and Shoal's
distribute-not-replicate array placement (``scripts/run.sh:66-105``):

* **Vertex ownership**: contiguous ranges — shard ``t`` owns global
  vertices ``[t*L, (t+1)*L)`` and holds their properties as a local
  ``[L]`` slab.  Per-device property footprint is O(N/S), not O(N).
* **Edge placement by destination owner**: CSC is sorted by destination,
  so shard ``t``'s edge set is a *contiguous CSC slice* — per-vertex
  segment reductions are fully local AND bit-identical in order to the
  single-device segment reduction (no cross-shard combine of partial
  sums, unlike the round-1 replicate+psum scheme).
* **Ghost exchange** (the "message" step): the only cross-shard traffic
  per superstep is the boundary values — for each (owner, consumer) pair
  a precomputed index list of owner-local vertices the consumer reads as
  edge sources.  Values ride one ``lax.all_to_all`` over the mesh axis
  (NCCL between GPUs), sized by the graph cut, not by N.
* **Master scalars** (convergence diff / frontier liveness): ``psum`` —
  the GPS master state machine's aggregators.

The exchange schedule (``send_idx`` + per-edge ghost pointers) is the
congruent-message-class analog: one fixed-capacity buffer layout reused
every superstep, built once host-side.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..graph.csr import Graph, round_up

INT32_MAX = jnp.iinfo(jnp.int32).max
INF_F32 = jnp.float32(jnp.inf)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VertexShardedGraph:
    """Destination-owner edge placement + ghost-exchange schedule.

    All ``[S, ...]`` arrays shard over the mesh axis on dim 0; each
    device sees one row.
    """

    dst_local: jax.Array   # [S, E_s] owner-local destination, L = pad
    src_vidx: jax.Array    # [S, E_s] index into the [S*cap] ghost table
    emask: jax.Array       # [S, E_s] real-edge mask
    csc_slot: jax.Array    # [S, E_s] global CSC slot id (edge props)
    send_idx: jax.Array    # [S, S, cap] owner-local indices to send
    deg_owned: jax.Array   # [S, L] out-degree of owned vertices

    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    num_shards: int = dataclasses.field(metadata=dict(static=True))
    L: int = dataclasses.field(metadata=dict(static=True))
    E_s: int = dataclasses.field(metadata=dict(static=True))
    cap: int = dataclasses.field(metadata=dict(static=True))
    ghost_total: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_glob(self) -> int:
        return self.num_shards * self.L


def build_vertex_sharded(g: Graph, num_shards: int) -> VertexShardedGraph:
    """Host-side (numpy) partition build — the gm_graph.cc freeze()
    analog for the distributed layout.  O(E log E) worst case, one pass
    over the CSC arrays plus per-pair unique/searchsorted on the
    boundary sets."""
    S = num_shards
    N, E = g.num_nodes, g.num_edges
    L = max(8, round_up(-(-N // S), 8))
    csc_dst = np.asarray(g.r_node_idx_dst)[:E]
    csc_src = np.asarray(g.r_node_idx)[:E]

    bounds = np.searchsorted(csc_dst, np.arange(S + 1) * L).astype(np.int64)
    counts = np.diff(bounds)
    E_s = max(8, round_up(int(counts.max()) if S else 8, 8))

    dst_local = np.full((S, E_s), L, np.int32)
    src_glob = np.zeros((S, E_s), np.int32)
    emask = np.zeros((S, E_s), bool)
    csc_slot = np.zeros((S, E_s), np.int32)
    for t in range(S):
        c = int(counts[t])
        sl = slice(int(bounds[t]), int(bounds[t + 1]))
        dst_local[t, :c] = csc_dst[sl] - t * L
        src_glob[t, :c] = csc_src[sl]
        emask[t, :c] = True
        csc_slot[t, :c] = np.arange(bounds[t], bounds[t + 1])

    # boundary sets: per consumer t, the unique sources grouped by owner
    send_lists = [[np.empty(0, np.int64)] * S for _ in range(S)]
    cap = 8
    ghost_total = 0
    uniqs = []
    for t in range(S):
        uniq = np.unique(src_glob[t][emask[t]])
        uniqs.append(uniq)
        owners = uniq // L
        cut = np.searchsorted(owners, np.arange(S + 1))
        for s in range(S):
            lst = uniq[cut[s]:cut[s + 1]]
            send_lists[s][t] = lst
            cap = max(cap, len(lst))
            ghost_total += len(lst)
    cap = max(8, round_up(cap, 8))

    send_idx = np.zeros((S, S, cap), np.int32)
    for s in range(S):
        for t in range(S):
            lst = send_lists[s][t]
            send_idx[s, t, : len(lst)] = lst - s * L

    # per-edge ghost pointer: src u owned by s at rank p in
    # send_lists[s][t]  ->  s*cap + p in the consumer's ghost table
    src_vidx = np.zeros((S, E_s), np.int32)
    for t in range(S):
        m = emask[t]
        u = src_glob[t][m].astype(np.int64)
        s_of = u // L
        pos = np.empty(len(u), np.int64)
        owners = uniqs[t] // L
        cut = np.searchsorted(owners, np.arange(S + 1))
        for s in range(S):
            sel = s_of == s
            if sel.any():
                pos[sel] = s * cap + np.searchsorted(send_lists[s][t],
                                                     u[sel])
        src_vidx[t][m] = pos

    deg = np.asarray(g.out_degree())
    deg_owned = np.zeros((S, L), deg.dtype)
    flat_n = min(S * L, deg.shape[0])
    deg_owned.reshape(-1)[:flat_n] = deg[:flat_n]

    return VertexShardedGraph(
        dst_local=jnp.asarray(dst_local),
        src_vidx=jnp.asarray(src_vidx),
        emask=jnp.asarray(emask),
        csc_slot=jnp.asarray(csc_slot),
        send_idx=jnp.asarray(send_idx),
        deg_owned=jnp.asarray(deg_owned),
        num_nodes=N, num_edges=E, num_shards=S,
        L=L, E_s=E_s, cap=cap, ghost_total=int(ghost_total),
    )


def vmesh(n: Optional[int] = None, axis: str = "v") -> Mesh:
    devs = jax.devices()
    if n is None:
        n = len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def place(vsg: VertexShardedGraph, mesh: Mesh,
          axis: str = "v") -> VertexShardedGraph:
    """Pin the [S, ...] slabs to their shard devices (Shoal
    distribute placement)."""
    def put(arr):
        spec = P(axis, *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return dataclasses.replace(
        vsg,
        dst_local=put(vsg.dst_local), src_vidx=put(vsg.src_vidx),
        emask=put(vsg.emask), csc_slot=put(vsg.csc_slot),
        send_idx=put(vsg.send_idx), deg_owned=put(vsg.deg_owned))


def shard_edge_prop(vsg: VertexShardedGraph, g: Graph,
                    w_csr: np.ndarray) -> jax.Array:
    """Rearrange a CSR-slot edge property into the shard's CSC-slice
    layout ``[S, E_s]`` (host-side, once)."""
    w_csc = np.asarray(w_csr)[np.asarray(g.e_rev2idx)]
    slab = w_csc[np.asarray(vsg.csc_slot)]
    return jnp.asarray(np.where(np.asarray(vsg.emask), slab, 0))


def _exchange(vals, send_idx_l, axis):
    """One ghost exchange: gather boundary values, all_to_all, flatten.

    ``vals`` [L] owned values; ``send_idx_l`` [S, cap]; returns the
    [S*cap] ghost table (row s = values from owner s)."""
    send = vals[send_idx_l]                       # [S, cap]
    recv = jax.lax.all_to_all(send, axis, 0, 0)   # [S, cap]
    return recv.reshape(-1)


def _local(x):
    """Drop the leading sharded dim shard_map leaves as size 1."""
    return x.reshape(x.shape[1:])


# ---------------------------------------------------------------------------
# Algorithms
# ---------------------------------------------------------------------------

def pagerank_vsharded(vsg: VertexShardedGraph, mesh: Mesh,
                      e: float = 0.001, d: float = 0.85,
                      max_iter: int = 100, dtype=jnp.float32,
                      axis: str = "v"):
    """PageRank with O(N/S) state: rank lives only on its owner.

    Per superstep: one ghost all_to_all of rank/deg, a fully-local
    segment_sum (bit-identical per-vertex order vs single device), and a
    psum'd L1 diff (master scalar)."""
    N, S, L = vsg.num_nodes, vsg.num_shards, vsg.L

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(axis, None), P(axis, None),
                       P(axis, None, None), P(axis, None)),
             out_specs=(P(axis), P(), P()), check_vma=False)
    def run(dst_l, vidx, emask, send_idx, deg):
        dst_l, vidx, emask, send_idx, deg = map(
            _local, (dst_l, vidx, emask, send_idx, deg))
        t = jax.lax.axis_index(axis)
        gid = t * L + jnp.arange(L, dtype=jnp.int32)
        owned = gid < N
        inv_n = jnp.asarray(1.0 / N, dtype)
        e_ = jnp.asarray(e, dtype)
        d_ = jnp.asarray(d, dtype)
        degf = deg.astype(dtype)
        inv_deg = jnp.where(degf > 0, 1.0 / jnp.maximum(degf, 1),
                            0.0).astype(dtype)
        rank0 = jnp.where(owned, inv_n, 0).astype(dtype)

        def cond(c):
            _, diff, it = c
            return jnp.logical_and(it < max_iter,
                                   jnp.logical_or(it == 0, diff > e_))

        def body(c):
            rank, _, it = c
            ghost = _exchange(rank * inv_deg, send_idx, axis)
            contrib = jnp.where(emask, ghost[vidx], 0)
            part = jax.ops.segment_sum(contrib, dst_l,
                                       num_segments=L + 1,
                                       indices_are_sorted=True)[:L]
            val = jnp.where(owned, (1 - d_) * inv_n + d_ * part, 0)
            diff = jax.lax.psum(jnp.sum(jnp.abs(val - rank)), axis)
            return val, diff, it + 1

        rank, diff, it = jax.lax.while_loop(
            cond, body,
            (rank0, jnp.zeros((), dtype), jnp.zeros((), jnp.int32)))
        return rank, diff, it

    rank, diff, it = run(vsg.dst_local, vsg.src_vidx, vsg.emask,
                         vsg.send_idx, vsg.deg_owned)
    return rank.reshape(-1)[:N], diff, it


def hop_dist_vsharded(vsg: VertexShardedGraph, mesh: Mesh, root: int,
                      max_iter: int = 0, axis: str = "v"):
    """Level-synchronous BFS (hop_dist.gm) with sharded dist: frontier
    flags exchanged as ghost values, expansion local per shard."""
    N, S, L = vsg.num_nodes, vsg.num_shards, vsg.L
    if max_iter <= 0:
        max_iter = N

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(axis, None), P(axis, None),
                       P(axis, None, None), P()),
             out_specs=(P(axis), P()), check_vma=False)
    def run(dst_l, vidx, emask, send_idx, root_):
        dst_l, vidx, emask, send_idx = map(
            _local, (dst_l, vidx, emask, send_idx))
        t = jax.lax.axis_index(axis)
        gid = t * L + jnp.arange(L, dtype=jnp.int32)
        owned = gid < N
        dist0 = jnp.where(gid == root_, 0, INT32_MAX)
        dist0 = jnp.where(owned, dist0, INT32_MAX)

        def cond(c):
            _, depth, live = c
            return jnp.logical_and(depth < max_iter, live > 0)

        def body(c):
            dist, depth, _ = c
            frontier = (dist == depth).astype(jnp.int32)
            ghost = _exchange(frontier, send_idx, axis)
            hit = jax.ops.segment_max(
                jnp.where(emask, ghost[vidx], 0), dst_l,
                num_segments=L + 1, indices_are_sorted=True)[:L]
            newly = (hit > 0) & (dist == INT32_MAX) & owned
            dist = jnp.where(newly, depth + 1, dist)
            live = jax.lax.psum(jnp.sum(newly.astype(jnp.int32)), axis)
            return dist, depth + 1, live

        dist, depth, _ = jax.lax.while_loop(
            cond, body, (dist0, jnp.zeros((), jnp.int32),
                         jnp.ones((), jnp.int32)))
        return dist, depth

    dist, depth = run(vsg.dst_local, vsg.src_vidx, vsg.emask,
                      vsg.send_idx, jnp.asarray(root, jnp.int32))
    return dist.reshape(-1)[:N], depth


def multi_bfs_vsharded(vsg: VertexShardedGraph, mesh: Mesh, roots,
                       max_iter: int = 0, axis: str = "v"):
    """Batched multi-source BFS with bit-packed instance planes AND
    O(N/S) owned state — the binned engine's plane scheme
    (``ops/binned.py``) carried onto the vertex-sharded mesh, i.e. the
    "bigger graphs go multi-chip" path for the flagship batched mode.

    ``roots`` [B] global node ids (B padded internally to a multiple
    of 32; W = B/32 packed uint32 words; pad-instance bits are
    cleared in the returned planes, so word popcounts are exact).  Per superstep: ONE ghost
    ``all_to_all`` of the frontier words (cut-sized × W, the GPS
    message step) + a fully-local segment-OR over the contiguous CSC
    slice.  Per-device state is [L, W] — N×B bits sharded S ways.

    Returns ``(visited [N, W] packed reachability planes, depth)``;
    bit b of word w at row v is set iff v is reachable from
    ``roots[w*32+b]``.
    """
    N, S, L = vsg.num_nodes, vsg.num_shards, vsg.L
    roots = jnp.asarray(roots, jnp.int32)
    B = int(roots.shape[0])
    Bp = round_up(B, 32)
    if Bp != B:
        # pad with root 0; padded planes are sliced off by the caller
        roots = jnp.concatenate(
            [roots, jnp.zeros((Bp - B,), jnp.int32)])
    W = Bp // 32
    if max_iter <= 0:
        max_iter = N

    from ..ops.segment import sorted_segment_or

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(axis, None), P(axis, None),
                       P(axis, None, None), P()),
             out_specs=(P(axis, None), P()), check_vma=False)
    def run(dst_l, vidx, emask, send_idx, roots_):
        dst_l, vidx, emask, send_idx = map(
            _local, (dst_l, vidx, emask, send_idx))
        t = jax.lax.axis_index(axis)
        gid = t * L + jnp.arange(L, dtype=jnp.int32)
        owned_rows = (gid < N)[:, None]

        # seed planes: bit (b % 32) of word (b // 32) at the owner's
        # local slot of roots[b].  Distinct b always means a distinct
        # (word, bit), so colliding adds never carry.
        lpos = roots_ - t * L                                  # [Bp]
        in_shard = (lpos >= 0) & (lpos < L)
        word = jnp.arange(Bp, dtype=jnp.int32) // 32
        bit = (jnp.arange(Bp, dtype=jnp.int32) % 32).astype(jnp.uint32)
        contrib = jnp.where(in_shard,
                            jnp.left_shift(jnp.uint32(1), bit),
                            jnp.uint32(0))
        plane0 = jnp.zeros((L + 1, W), jnp.uint32).at[
            jnp.where(in_shard, lpos, L), word].add(contrib)[:L]

        def cond(c):
            _, _, depth, live = c
            return jnp.logical_and(depth < max_iter, live > 0)

        def body(c):
            visited, frontier, depth, _ = c
            send = frontier[send_idx]                   # [S, cap, W]
            recv = jax.lax.all_to_all(send, axis, 0, 0)
            ghost = recv.reshape(-1, W)                 # [S*cap, W]
            gathered = jnp.where(emask[:, None], ghost[vidx],
                                 jnp.uint32(0))
            hit = sorted_segment_or(gathered, dst_l, L + 1)[:L]
            newly = jnp.where(owned_rows, hit & ~visited,
                              jnp.uint32(0))
            visited = visited | newly
            # liveness in f32: popcount sums can exceed int32 at scale
            live = jax.lax.psum(
                jnp.sum(jax.lax.population_count(newly)
                        .astype(jnp.float32)), axis)
            return visited, newly, depth + 1, live

        visited, _, depth, _ = jax.lax.while_loop(
            cond, body, (plane0, plane0, jnp.zeros((), jnp.int32),
                         jnp.ones((), jnp.float32)))
        return visited, depth

    vis, depth = run(vsg.dst_local, vsg.src_vidx, vsg.emask,
                     vsg.send_idx, roots)
    vis = vis.reshape(-1, W)[:N]
    if Bp != B:
        # clear the pad-instance bits (seeded with root 0) so word
        # popcounts over the planes never over-count — packed bits
        # cannot be "sliced off" by the caller
        vis = vis.at[:, W - 1].set(
            vis[:, W - 1] & jnp.uint32((1 << (B % 32)) - 1))
    return vis, depth


def sssp_vsharded(vsg: VertexShardedGraph, mesh: Mesh, w_slab,
                  root: int, max_iter: int = 0, axis: str = "v"):
    """Bellman-Ford (sssp.gm) with sharded dist and sharded edge
    weights; relaxation is a local segment_min over ghost dist + w."""
    N, S, L = vsg.num_nodes, vsg.num_shards, vsg.L
    if max_iter <= 0:
        max_iter = N
    wdt = jnp.asarray(w_slab).dtype
    # unreached sentinel matches the single-device path and the
    # reference's (int)+INF saturation: INT32_MAX for integer dists
    BIG = (jnp.asarray(jnp.iinfo(wdt).max, wdt)
           if jnp.issubdtype(wdt, jnp.integer) else INF_F32.astype(wdt))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(axis, None), P(axis, None),
                       P(axis, None, None), P(axis, None), P()),
             out_specs=(P(axis), P()), check_vma=False)
    def run(dst_l, vidx, emask, send_idx, w, root_):
        dst_l, vidx, emask, send_idx, w = map(
            _local, (dst_l, vidx, emask, send_idx, w))
        t = jax.lax.axis_index(axis)
        gid = t * L + jnp.arange(L, dtype=jnp.int32)
        owned = gid < N
        dist0 = jnp.where((gid == root_) & owned,
                          jnp.zeros((), wdt), BIG)

        def cond(c):
            _, it, changed = c
            return jnp.logical_and(it < max_iter, changed > 0)

        def body(c):
            dist, it, _ = c
            ghost = _exchange(dist, send_idx, axis)
            gv = ghost[vidx]
            # never add to the sentinel (INT32_MAX + w would wrap)
            cand = jnp.where(emask & (gv < BIG), gv + w, BIG)
            m = jax.ops.segment_min(cand, dst_l, num_segments=L + 1,
                                    indices_are_sorted=True)[:L]
            newd = jnp.where(owned, jnp.minimum(dist, m), BIG)
            changed = jax.lax.psum(
                jnp.sum((newd < dist).astype(jnp.int32)), axis)
            return newd, it + 1, changed

        dist, it, _ = jax.lax.while_loop(
            cond, body, (dist0, jnp.zeros((), jnp.int32),
                         jnp.ones((), jnp.int32)))
        return dist, it

    dist, it = run(vsg.dst_local, vsg.src_vidx, vsg.emask,
                   vsg.send_idx, w_slab, jnp.asarray(root, jnp.int32))
    return dist.reshape(-1)[:N], it


# ---------------------------------------------------------------------------
# Placement report (Shoal decision table, gm_cpp_gen.cc:229-305)
# ---------------------------------------------------------------------------

def placement_report(vsg: VertexShardedGraph, mesh: Mesh,
                     axis: str = "v") -> str:
    """Per-array placement table: name, global shape, per-device shape,
    bytes/device, policy — the analog of the compiler-printed Shoal
    array decision table and the runtime ``Array[...]`` report lines."""
    S = mesh.shape[axis]
    rows = []
    for f in ("dst_local", "src_vidx", "emask", "csc_slot",
              "send_idx", "deg_owned"):
        a = getattr(vsg, f)
        per_dev = (a.size // S) * a.dtype.itemsize
        shp = "x".join(str(d) for d in a.shape)
        rows.append(f"Array[{f}]: elements={a.size} global={shp} "
                    f"bytes/device={per_dev} -- "
                    f"replication=[ ] distribution=[X] axis={axis}")
    rows.append(f"Array[node_prop]: elements={vsg.n_glob} "
                f"global={vsg.num_shards}x{vsg.L} "
                f"bytes/device={vsg.L * 4} -- "
                f"replication=[ ] distribution=[X] axis={axis}")
    rows.append(f"# ghost exchange: total={vsg.ghost_total} ids, "
                f"cap={vsg.cap}/pair, "
                f"bytes/superstep/device={vsg.num_shards * vsg.cap * 4}")
    return "\n".join(rows)
