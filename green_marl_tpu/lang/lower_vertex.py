"""DSL-level vertex-sharded lowering: compiled programs get O(N/S) state.

This closes the gap between the hand-written vertex-sharded engine
(``parallel/vertex_sharded.py``) and the compiler: the reference's GPS
backend makes *any feasible compiled procedure* run vertex-partitioned
with typed per-superstep messages (``src/inc/gps_comminfo.h:8-100``,
``src/backend_gps/gm_gps_new_rewrite_rhs.cc``,
``gm_gps_find_congruent_message.cc``).  Here the same capability is a
``Lowerer`` subclass that executes the lowered AST inside ``shard_map``
against a per-shard **LocalView** of the graph:

* **Node space** is ``[Lh] = [L + G]``: an owned slab of ``L = ceil(N/S)``
  vertices plus a ghost *halo* of ``G = S*cap`` boundary values.  Every
  node-property array in the environment is an ``[Lh]`` slab — per-shard
  property footprint is O(N/S) + O(cut), never O(N).
* **Edge space** is the shard's contiguous CSC slice (destination-owner
  placement): per-vertex segment reductions are fully local and
  bit-identical in order to the single-device CSC reduction.
* **Ghost reads** (``n.dist`` at the edge-source endpoint) index the halo
  region; the halo is refreshed by one ``lax.all_to_all`` per stale
  property — the GPS "message" step, sized by the graph cut.
* **Freshness is tracked by array identity**: a property's halo is valid
  iff its array object is the one produced by the last exchange.  Any
  write creates a new array, while-loop carries and If-merges substitute
  new arrays — staleness propagates through *all* control flow with no
  hooks.
* **Master scalars** (convergence diffs, Exist() liveness) finish with
  ``psum``/``pmin``/``pmax`` over the mesh axis, the GPS master-state
  aggregators.

Feasibility rules mirror the reference's distributed backend: random
scatter writes, reductions into the *ghost* endpoint of a loop (write
"against" the edge placement), nested neighbor iteration, collections,
RNG, and BFS statements are rejected with remedies
(``gm_gps_new_check_random_read.cc`` / ``..._random_write.cc`` — the
reference rejects the same shapes).  All three flagship supersteppers
(pagerank.gm, hop_dist.gm, sssp.gm) and the other level-sync apps lower
unmodified.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from . import gm_ast as A
from ..graph.csr import Graph, round_up
from ..ops import segment as ops
from .lower import (
    CompiledProc, EdgeCtx, Lowerer, LowerError, NodeCtx, _F, _RET, _coerce,
    _combine, _identity, _SEG_OP, _float_dtype, _walk_ast, dtype_of_kind,
    written_keys,
)

INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# Host-side schedule build (the gm_graph freeze() analog for the
# compiled distributed layout; superset of parallel.vertex_sharded's)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VertexSchedule:
    """Destination-owner edge slabs + ghost-exchange schedule, in global
    ``[S, ...]`` form (dim 0 shards over the mesh axis)."""

    dst_lpos: jax.Array    # [S, E_s] owner-local destination (pad = L)
    src_lpos: jax.Array    # [S, E_s] halo position of the source (= L + g)
    src_gid: jax.Array     # [S, E_s] global source id (pad = N)
    emask: jax.Array       # [S, E_s] real-edge mask
    csr_slot: jax.Array    # [S, E_s] global CSR slot (edge-prop binding)
    gslot: jax.Array       # [S, E_s] global CSC slot (determinism order)
    send_idx: jax.Array    # [S, S, cap] owner-local indices to send
    send_mask: jax.Array   # [S, S, cap] True where send_idx is a real id
    ghost_gid: jax.Array   # [S, G] global id of each halo position (pad N)
    deg_out: jax.Array     # [S, Lh] out-degree (owned + halo)
    deg_in: jax.Array      # [S, Lh] in-degree (owned + halo)
    csc_off: jax.Array     # [S, L+1] local CSC offsets per owned vertex

    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    num_shards: int = dataclasses.field(metadata=dict(static=True))
    L: int = dataclasses.field(metadata=dict(static=True))
    E_s: int = dataclasses.field(metadata=dict(static=True))
    cap: int = dataclasses.field(metadata=dict(static=True))
    ghost_total: int = dataclasses.field(metadata=dict(static=True))

    @property
    def G(self) -> int:
        return self.num_shards * self.cap

    @property
    def Lh(self) -> int:
        return self.L + self.G


def build_schedule(g: Graph, num_shards: int) -> VertexSchedule:
    """One host pass over the CSC arrays (numpy).  Shard ``t`` owns
    global vertices ``[t*L, (t+1)*L)``; its edge set is the contiguous
    CSC slice of edges whose *destination* it owns."""
    S = num_shards
    N, E = g.num_nodes, g.num_edges
    L = max(8, round_up(-(-N // S), 8))
    csc_dst = np.asarray(g.r_node_idx_dst)[:E]
    csc_src = np.asarray(g.r_node_idx)[:E]
    e_rev = np.asarray(g.e_rev2idx)[:E]

    bounds = np.searchsorted(csc_dst, np.arange(S + 1) * L).astype(np.int64)
    counts = np.diff(bounds)
    E_s = max(8, round_up(int(counts.max()) if S else 8, 8))

    dst_lpos = np.full((S, E_s), L, np.int32)
    src_gid = np.full((S, E_s), N, np.int32)
    emask = np.zeros((S, E_s), bool)
    csr_slot = np.zeros((S, E_s), np.int32)
    gslot = np.full((S, E_s), INT32_MAX, np.int32)
    for t in range(S):
        c = int(counts[t])
        sl = slice(int(bounds[t]), int(bounds[t + 1]))
        dst_lpos[t, :c] = csc_dst[sl] - t * L
        src_gid[t, :c] = csc_src[sl]
        emask[t, :c] = True
        csr_slot[t, :c] = e_rev[sl]
        gslot[t, :c] = np.arange(bounds[t], bounds[t + 1])

    # boundary sets: per consumer t, unique REMOTE sources grouped by
    # owner — sources t itself owns resolve directly into the owned slab
    # (no halo slot, no traffic), so the halo is sized by the true cut
    send_lists = [[np.empty(0, np.int64)] * S for _ in range(S)]
    cap = 8
    ghost_total = 0
    for t in range(S):
        uniq = np.unique(src_gid[t][emask[t]]).astype(np.int64)
        uniq = uniq[(uniq < t * L) | (uniq >= (t + 1) * L)]
        owners = uniq // L
        cut = np.searchsorted(owners, np.arange(S + 1))
        for s in range(S):
            lst = uniq[cut[s]:cut[s + 1]]
            send_lists[s][t] = lst
            cap = max(cap, len(lst))
            ghost_total += len(lst)
    cap = max(8, round_up(cap, 8))
    Gh = S * cap

    send_idx = np.zeros((S, S, cap), np.int32)
    send_mask = np.zeros((S, S, cap), bool)
    ghost_gid = np.full((S, Gh), N, np.int32)
    for s in range(S):
        for t in range(S):
            lst = send_lists[s][t]
            send_idx[s, t, : len(lst)] = lst - s * L
            send_mask[s, t, : len(lst)] = True
            ghost_gid[t, s * cap: s * cap + len(lst)] = lst

    # per-edge position: own sources -> owned slab [0, L); remote src u
    # owned by s at rank p in send_lists[s][t] -> halo L + s*cap + p
    src_lpos = np.full((S, E_s), L, np.int32)
    for t in range(S):
        m = emask[t]
        u = src_gid[t][m].astype(np.int64)
        s_of = u // L
        pos = np.empty(len(u), np.int64)
        own = s_of == t
        pos[own] = u[own] - t * L
        for s in range(S):
            sel = (s_of == s) & ~own
            if sel.any():
                pos[sel] = L + s * cap + np.searchsorted(
                    send_lists[s][t], u[sel])
        src_lpos[t][m] = pos

    # degree tables (static) for owned + halo positions
    degN = np.zeros(N + 1, np.int32)
    degN[:N] = np.diff(np.asarray(g.begin))[:N]
    indegN = np.zeros(N + 1, np.int32)
    indegN[:N] = np.diff(np.asarray(g.r_begin))[:N]
    Lh = L + Gh
    deg_out = np.zeros((S, Lh), np.int32)
    deg_in = np.zeros((S, Lh), np.int32)
    for t in range(S):
        lo, hi = t * L, min((t + 1) * L, N)
        if hi > lo:
            deg_out[t, : hi - lo] = degN[lo:hi]
            deg_in[t, : hi - lo] = indegN[lo:hi]
        gg = np.minimum(ghost_gid[t], N)
        deg_out[t, L:] = degN[gg]
        deg_in[t, L:] = indegN[gg]

    csc_off = np.zeros((S, L + 1), np.int32)
    for t in range(S):
        csc_off[t] = np.searchsorted(dst_lpos[t], np.arange(L + 1))

    return VertexSchedule(
        dst_lpos=jnp.asarray(dst_lpos), src_lpos=jnp.asarray(src_lpos),
        src_gid=jnp.asarray(src_gid), emask=jnp.asarray(emask),
        csr_slot=jnp.asarray(csr_slot), gslot=jnp.asarray(gslot),
        send_idx=jnp.asarray(send_idx), send_mask=jnp.asarray(send_mask),
        ghost_gid=jnp.asarray(ghost_gid),
        deg_out=jnp.asarray(deg_out), deg_in=jnp.asarray(deg_in),
        csc_off=jnp.asarray(csc_off),
        num_nodes=N, num_edges=E, num_shards=S,
        L=L, E_s=E_s, cap=cap, ghost_total=int(ghost_total))


def place_schedule(sched: VertexSchedule, mesh: Mesh,
                   axis: str = "v") -> VertexSchedule:
    """Pin each [S, ...] slab to its shard device."""
    def put(arr):
        spec = P(axis, *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, sched)


# ---------------------------------------------------------------------------
# Per-shard graph view (duck-typed Graph for the Lowerer)
# ---------------------------------------------------------------------------

class LocalView:
    """What one shard sees: local slab arrays + halo-extended node space.

    Mimics the ``Graph`` surface the ``Lowerer`` touches (``n_pad``,
    ``e_pad``, ``node_prop``, ``edge_prop``, degree/mask accessors,
    ``r_node_idx_dst``/``csc_offsets`` for the sorted per-vertex
    reduction) with per-shard sizes.  ``num_nodes``/``num_edges`` stay
    GLOBAL — they are semantic quantities (``G.NumNodes()``)."""

    def __init__(self, sched: VertexSchedule, gid_base,
                 dst_lpos, src_lpos, src_gid, emask, csr_slot, gslot,
                 send_idx, send_mask, ghost_gid, deg_out, deg_in,
                 csc_off):
        self.num_nodes = sched.num_nodes
        self.num_edges = sched.num_edges
        self.num_shards = sched.num_shards
        self.L = sched.L
        self.G = sched.G
        self.cap = sched.cap
        self.gid_base = gid_base        # traced scalar: t * L
        self.dst_lpos = dst_lpos        # [E_s]
        self.src_lpos = src_lpos        # [E_s]
        self.src_gid = src_gid          # [E_s]
        self.emask = emask              # [E_s]
        self.csr_slot = csr_slot        # [E_s]
        self.gslot = gslot              # [E_s]
        self.send_idx = send_idx        # [S, cap]
        self.send_mask = send_mask      # [S, cap]
        self.ghost_gid = ghost_gid      # [G]
        self.deg_out_full = deg_out     # [Lh]
        self.deg_in_full = deg_in       # [Lh]
        self.csc_off = csc_off          # [L+1]

    # --- Graph surface -----------------------------------------------------
    @property
    def n_pad(self) -> int:
        return self.L + self.G

    @property
    def e_pad(self) -> int:
        return int(self.dst_lpos.shape[0])

    @property
    def sentinel(self):
        return self.num_nodes

    def node_prop(self, fill, dtype):
        return jnp.full((self.n_pad,), fill, dtype=dtype)

    def edge_prop(self, fill, dtype):
        return jnp.full((self.e_pad,), fill, dtype=dtype)

    def edge_mask(self):
        return self.emask

    def node_mask(self):
        # owned positions only; the halo is never iterated
        lp = jnp.arange(self.n_pad, dtype=jnp.int32)
        return (lp < self.L) & (self.gid_base + lp < self.num_nodes)

    def out_degree(self):
        return self.deg_out_full

    def in_degree(self):
        return self.deg_in_full

    # sorted per-vertex reduction surface (CSC direction only: the edge
    # placement IS the CSC order)
    @property
    def r_node_idx_dst(self):
        return self.dst_lpos

    def csc_offsets(self):
        return self.csc_off

    @property
    def e_rev2idx(self):
        # edge properties are bound pre-permuted into slab order
        return jnp.arange(self.e_pad, dtype=jnp.int32)

    @property
    def e_base(self):
        return None


@dataclasses.dataclass
class VEdgeCtx(EdgeCtx):
    """Edge context over the local slab: ids are GLOBAL (comparison
    semantics), lpos index the [Lh] halo-extended node space."""
    outer_lpos: Optional[jax.Array] = None
    inner_lpos: Optional[jax.Array] = None
    outer_is_halo: bool = False
    inner_is_halo: bool = False


# ---------------------------------------------------------------------------
# The vertex-sharded lowerer
# ---------------------------------------------------------------------------

class VertexLowerer(Lowerer):
    """Executes a lowered procedure against a shard's LocalView inside
    ``shard_map``.  See module docstring for the placement/exchange
    model; overridden methods are the points where node-space indexing,
    per-vertex reductions, and master-scalar combines differ from the
    replicated single-device lowering."""

    def __init__(self, proc: A.Procedure, gl: LocalView, axis: str):
        super().__init__(proc, gl, axis=axis)
        # halo cache: prop key -> the array object whose halo region is
        # consistent with its owned slab (identity comparison; any write
        # yields a new object => stale)
        self._halo_ok: Dict[str, object] = {}
        # trace-time count of all_to_all exchange launches — the test
        # hook for the one-exchange-per-superstep guarantee (the GPS
        # congruent-message merge, gm_gps_find_congruent_message.cc)
        self.exchange_count: int = 0

    # ---- ghost exchange ---------------------------------------------------
    def _exchange(self, owned):
        """[L] owned values -> [G] halo table via one all_to_all."""
        gl = self.g
        v = owned
        as_bool = v.dtype == jnp.bool_
        if as_bool:
            v = v.astype(jnp.int8)
        send = v[gl.send_idx]                                # [S, cap]
        self.exchange_count += 1
        recv = jax.lax.all_to_all(send, self.axis, 0, 0)     # [S, cap]
        out = recv.reshape(-1)
        return out.astype(jnp.bool_) if as_bool else out

    # 4-byte wire format for the fused exchange: everything bitcasts or
    # widens to int32 (the GPS backend likewise unions congruent message
    # classes into one fixed wire layout, gps_comminfo.h:8-100)
    _WIRE_OK = (jnp.int32, jnp.uint32, jnp.float32, jnp.bool_, jnp.int8)

    def _to_wire(self, v):
        if v.dtype in (jnp.bool_, jnp.int8):
            return v.astype(jnp.int32)
        if v.dtype in (jnp.uint32, jnp.float32):
            return jax.lax.bitcast_convert_type(v, jnp.int32)
        return v

    def _from_wire(self, w, dt):
        if dt in (jnp.bool_, jnp.int8):
            return w.astype(dt)
        if dt in (jnp.uint32, jnp.float32):
            return jax.lax.bitcast_convert_type(w, dt)
        return w

    def _ensure_halos(self, keys, env):
        """Refresh the halos of every stale property in ``keys`` with ONE
        fused ``all_to_all`` — the analog of the reference GPS backend's
        congruent-message merge (``gm_gps_find_congruent_message.cc``):
        k properties consumed in one superstep ride one wire exchange,
        not k.  Properties whose dtype has no 4-byte wire form fall back
        to the per-prop path."""
        gl = self.g
        stale, fallback = [], []
        for k in keys:
            arr = env.get(k)
            if arr is None or not isinstance(arr, jax.Array) or \
                    arr.ndim != 1 or arr.shape[0] != gl.L + gl.G:
                continue
            if self._halo_ok.get(k) is arr:
                continue
            (stale if jnp.dtype(arr.dtype) in
             [jnp.dtype(d) for d in self._WIRE_OK] else fallback).append(k)
        for k in fallback:
            self._ensure_halo(k, env)
        if not stale:
            return
        if len(stale) == 1:
            self._ensure_halo(stale[0], env)
            return
        sends, dts = [], []
        for k in stale:
            v = env[k][:gl.L]
            dts.append(v.dtype)
            sends.append(self._to_wire(v)[gl.send_idx])      # [S, cap]
        bundle = jnp.stack(sends, axis=-1)                   # [S, cap, K]
        self.exchange_count += 1
        recv = jax.lax.all_to_all(bundle, self.axis, 0, 0)   # [S, cap, K]
        halos = recv.reshape(gl.G, len(stale))
        for i, k in enumerate(stale):
            h = self._from_wire(halos[:, i], dts[i])
            new = env[k].at[gl.L:].set(h)
            env[k] = new
            self._halo_ok[k] = new

    def _with_halo(self, v):
        """Extend an [L] owned vector to [Lh] with a fresh halo."""
        return jnp.concatenate([v, self._exchange(v)])

    def _reverse_reduce(self, work, mask, edge_lpos, sub, ident):
        """Per-vertex reduce into the *ghost* (source) endpoint: combine
        edge values per halo position locally, ship each partial back to
        its owner over the reverse all_to_all, and fold per owned vertex
        — the GPS message-combiner step
        (``gm_gps_find_congruent_message.cc``).  Returns ([L] per-owned
        combine, [L] touched mask)."""
        gl = self.g
        segf = {"add": ops.segment_sum, "min": ops.segment_min,
                "max": ops.segment_max}[sub]
        # sources this shard owns contribute directly into the owned slab
        is_local = edge_lpos < gl.L
        lmask = mask & is_local
        lkeys = jnp.where(lmask, edge_lpos, jnp.asarray(gl.L, jnp.int32))
        res_l = segf(jnp.where(lmask, work, ident), lkeys, gl.L + 1,
                     sorted_ids=False)[:gl.L]
        touched_l = ops.segment_max(
            lmask.astype(jnp.int8), lkeys, gl.L + 1,
            sorted_ids=False)[:gl.L] > 0
        # remote sources: combine per halo position, ship the partial
        # back to the owner over the reverse all_to_all
        hmask = mask & ~is_local
        gidx = jnp.clip(edge_lpos - gl.L, 0, gl.G - 1)
        part = segf(jnp.where(hmask, work, ident), gidx, gl.G,
                    sorted_ids=False)                          # [G]
        hit = ops.segment_max(hmask.astype(jnp.int8), gidx, gl.G,
                              sorted_ids=False)
        # consumer row-major [S, cap] -> owner sees one row per
        # consumer, aligned with send_idx/send_mask
        def back(x):
            return jax.lax.all_to_all(x.reshape(gl.send_idx.shape),
                                      self.axis, 0, 0).reshape(-1)
        part_b = back(part)
        hit_b = back(hit.astype(jnp.int8))
        keys = jnp.where(gl.send_mask.reshape(-1),
                         gl.send_idx.reshape(-1),
                         jnp.asarray(gl.L, jnp.int32))
        valid = gl.send_mask.reshape(-1) & (hit_b > 0)
        res_h = segf(jnp.where(valid, part_b, ident), keys, gl.L + 1,
                     sorted_ids=False)[:gl.L]
        touched_h = ops.segment_max(
            jnp.where(valid, jnp.int8(1), jnp.int8(0)), keys, gl.L + 1,
            sorted_ids=False)[:gl.L] > 0
        comb = {"add": jnp.add, "min": jnp.minimum,
                "max": jnp.maximum}[sub]
        return comb(res_l, res_h), touched_l | touched_h

    def _ensure_halo(self, key: str, env):
        arr = env[key]
        if self._halo_ok.get(key) is arr:
            return arr
        gl = self.g
        new = arr.at[gl.L:].set(self._exchange(arr[:gl.L]))
        env[key] = new
        self._halo_ok[key] = new
        return new

    # ---- local-position resolution ----------------------------------------
    def _lpos(self, name: str, env, ctx):
        """Resolve a node-variable driver to positions in the [Lh] node
        space.  Returns (lpos, needs_halo) or ("scalar", gid)."""
        if ctx is not None:
            if ctx.kind == "node":
                if name == ctx.var or name in ctx.aliases:
                    return jnp.arange(self.g.L, dtype=jnp.int32), False
            elif ctx.kind == "edge":
                if name == ctx.inner_var:
                    return ctx.inner_lpos, ctx.inner_is_halo
                if name == ctx.outer_var:
                    return ctx.outer_lpos, ctx.outer_is_halo
                if ctx.parent is not None and (
                        name == ctx.parent.var
                        or name in ctx.parent.aliases):
                    return ctx.outer_lpos, ctx.outer_is_halo
        if name not in env:
            raise LowerError(f"unbound symbol {name}")
        v = env[name]
        if isinstance(v, jax.Array) and v.ndim == 0:
            return "scalar", v
        raise LowerError(
            f"cannot resolve node positions for {name} under "
            "vertex-sharded lowering")

    def _owner_read(self, arr, gid):
        """Read arr[gid] (global scalar id): owner contributes, psum."""
        gl = self.g
        lp = jnp.asarray(gid, jnp.int32) - gl.gid_base
        owned = (lp >= 0) & (lp < gl.L)
        lpc = jnp.clip(lp, 0, gl.L - 1)
        v = arr[lpc]
        if v.dtype == jnp.bool_:
            w = jnp.where(owned, v.astype(jnp.int32), 0)
            return jax.lax.psum(w, self.axis) > 0
        w = jnp.where(owned, v, jnp.zeros((), v.dtype))
        return jax.lax.psum(w, self.axis)

    def _owner_write(self, arr, gid, new_val):
        """arr.at[gid].set(val) for a global scalar id: only the owner
        commits."""
        gl = self.g
        lp = jnp.asarray(gid, jnp.int32) - gl.gid_base
        owned = (lp >= 0) & (lp < gl.L)
        lpc = jnp.clip(lp, 0, gl.L - 1)
        cur = arr[lpc]
        nv = jnp.where(owned, jnp.asarray(new_val, arr.dtype), cur)
        return arr.at[lpc].set(nv)

    # ---- identifier / field access ----------------------------------------
    def _ident(self, name, env, ctx):
        # node-loop-local [L] vectors read from an edge ctx: gather at the
        # outer endpoint (haloized when the outer side is remote)
        if ctx is not None and ctx.kind == "edge" and \
                name not in (ctx.inner_var, ctx.outer_var) and \
                not (ctx.parent is not None and (
                    name == ctx.parent.var or name in ctx.parent.aliases)) \
                and name in env:
            v = env[name]
            if isinstance(v, jax.Array) and v.ndim == 1 and \
                    v.shape[0] == self.g.L:
                vh = self._with_halo(v) if ctx.outer_is_halo else v
                lp = jnp.clip(ctx.outer_lpos, 0, vh.shape[0] - 1)
                return vh[lp]
        return super()._ident(name, env, ctx)

    def _field_read(self, f: A.Field, env, ctx):
        key = _F + f.prop
        if key not in env:
            raise LowerError(f"unbound property {f.prop}")
        loc, _dt = self.props[f.prop]
        if loc == "E":
            if ctx is not None and ctx.kind == "edge":
                # any reachable edge identity IS the current slot
                self._edge_slot_driver(f.driver, ctx)
                return env[key]
            if ctx is None:
                # scalar global edge id: the owning shard finds it in its
                # slab by global CSR slot, psum-selects the value
                gid = self._ident(f.driver, env, ctx)
                gl = self.g
                hit = (gl.csr_slot == jnp.asarray(gid, jnp.int32)) & \
                    gl.emask
                arr = env[key]
                if arr.dtype == jnp.bool_:
                    w = jnp.where(hit, arr.astype(jnp.int32), 0)
                    return jax.lax.psum(jnp.max(w), self.axis) > 0
                w = jnp.where(hit, arr, jnp.zeros((), arr.dtype))
                return jax.lax.psum(jnp.sum(w), self.axis)
            raise LowerError(
                f"edge property {f.prop} access in a {ctx.kind} context "
                "not supported in vertex-sharded lowering")
        r = self._lpos(f.driver, env, ctx)
        if isinstance(r, tuple) and len(r) == 2 and r[0] == "scalar":
            return self._owner_read(env[key], r[1])
        lpos, needs_halo = r
        arr = self._ensure_halo(key, env) if needs_halo else env[key]
        return arr[lpos]

    def _mark_stale(self, key: str):
        self._halo_ok.pop(key, None)

    # node-space write helpers ----------------------------------------------
    def _write_owned(self, env, key, mask_l, val):
        """Masked write of [L]-space values into the [Lh] slab."""
        arr = env[key]
        gl = self.g
        v = jnp.asarray(val)
        if v.ndim == 0:
            v = jnp.broadcast_to(v, (gl.L,))
        new = jnp.where(mask_l, v.astype(arr.dtype), arr[:gl.L])
        self._wr(env, key, arr.at[:gl.L].set(new))
        self._mark_stale(key)

    # ---- builtins ----------------------------------------------------------
    def _builtin(self, e: A.Builtin, env, ctx):
        name = e.name.lower()
        gl = self.g
        if e.driver is not None and e.driver in self.graphs:
            if ctx is not None and ctx.kind == "node" and \
                    e.driver in ctx.aliases:
                if name in ("degree", "outdegree", "numnbrs"):
                    return gl.deg_out_full[:gl.L]
                if name in ("indegree", "numinnbrs"):
                    return gl.deg_in_full[:gl.L]
            return super()._builtin(e, env, ctx)
        if e.driver is not None and e.driver not in self.collections:
            if name in ("degree", "outdegree", "numnbrs",
                        "indegree", "numinnbrs"):
                deg = (gl.deg_out_full
                       if name in ("degree", "outdegree", "numnbrs")
                       else gl.deg_in_full)
                r = self._lpos(e.driver, env, ctx)
                if isinstance(r, tuple) and len(r) == 2 and \
                        r[0] == "scalar":
                    return self._owner_read(deg[:gl.L], r[1])
                lpos, _halo = r          # degrees are static: halo valid
                return deg[lpos]
            if name in ("fromnode", "from"):
                self._edge_slot_driver(e.driver, ctx)
                return gl.src_gid
            if name in ("tonode", "to"):
                self._edge_slot_driver(e.driver, ctx)
                return gl.gid_base + gl.dst_lpos
            if name == "toedge":
                if ctx is None or ctx.kind != "edge" or (
                        e.driver != ctx.inner_var
                        and e.driver != ctx.outer_var):
                    raise LowerError("ToEdge() outside a neighbor loop")
                # edge VALUES are global CSR slots (bit-compatible with
                # the single-device lowering); property access inside
                # the loop resolves to the current slab slot instead
                return gl.csr_slot
        return super()._builtin(e, env, ctx)

    def _edge_slot_driver(self, name: str, ctx):
        """Check that an edge-variable driver denotes the current slot of
        the active edge context (the only edge identity reachable in the
        vertex-sharded subset)."""
        if ctx is not None and ctx.kind == "edge" and (
                (ctx.inner_is_edge and name == ctx.inner_var)
                or name in ctx.locals):
            return
        raise LowerError(
            f"edge variable {name} does not denote the current edge slot "
            "(random edge access is infeasible under vertex sharding)")

    # ---- contexts ----------------------------------------------------------
    def _node_ctx(self, it: A.Iterator, env, ctx, aliases=()):
        if ctx is not None:
            raise LowerError("whole-graph loop nested inside a parallel "
                             "context is not lowerable")
        gl = self.g
        gid = gl.gid_base + jnp.arange(gl.L, dtype=jnp.int32)
        return NodeCtx(g=gl, var=it.var, ids=gid,
                       mask=gid < gl.num_nodes, aliases=tuple(aliases))

    def _edge_ctx(self, it: A.Iterator, env, ctx):
        gl = self.g
        dst_gid = gl.gid_base + gl.dst_lpos
        level_filter = None
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            layout = "csr"
            o_gid, o_lp, o_halo = gl.src_gid, gl.src_lpos, True
            i_gid, i_lp, i_halo = dst_gid, gl.dst_lpos, False
        elif it.iter_type == "IN_NBRS":
            layout = "csc"
            o_gid, o_lp, o_halo = dst_gid, gl.dst_lpos, False
            i_gid, i_lp, i_halo = gl.src_gid, gl.src_lpos, True
        elif it.iter_type in ("UP_NBRS", "DOWN_NBRS"):
            # BFS-tree-relative neighbors inside an InBFS replay: Up =
            # in-neighbors one level shallower, Down = out-neighbors one
            # level deeper (gm_cpp_gen_foreach.cc level checks); the
            # level array is an [L] owned slab, haloized for the remote
            # endpoint
            if self._bfs_ctx is None or self._bfs_ctx[0] != it.source:
                raise LowerError(f"{it.iter_type} outside its InBFS "
                                 "body")
            _, level, d = self._bfs_ctx
            if it.iter_type == "UP_NBRS":
                layout = "csc"
                o_gid, o_lp, o_halo = dst_gid, gl.dst_lpos, False
                i_gid, i_lp, i_halo = gl.src_gid, gl.src_lpos, True
                lvl_h = self._with_halo(level)
                level_filter = lvl_h[gl.src_lpos] == (d - 1)
            else:
                layout = "csr"
                o_gid, o_lp, o_halo = gl.src_gid, gl.src_lpos, True
                i_gid, i_lp, i_halo = dst_gid, gl.dst_lpos, False
                level_filter = (
                    (level[jnp.clip(gl.dst_lpos, 0, gl.L - 1)]
                     == (d + 1)) & (gl.dst_lpos < gl.L))
        elif it.iter_type == "EDGES":
            # the loop variable's VALUE is the global CSR slot (matches
            # single-device edge ids); slab-local access uses lpos
            return VEdgeCtx(
                g=gl, layout="csr", outer_var="", inner_var=it.var,
                outer_ids=gl.src_gid, inner_ids=gl.csr_slot,
                mask=gl.emask, parent=None, inner_is_edge=True,
                outer_lpos=gl.src_lpos, inner_lpos=gl.dst_lpos,
                outer_is_halo=True, inner_is_halo=False)
        else:
            raise LowerError(
                f"iterator {it.iter_type} not supported in vertex-sharded "
                "lowering (rewrite as Nbrs/InNbrs supersteps)")
        mask = gl.emask
        if level_filter is not None:
            mask = mask & level_filter
        src_name = it.source
        if ctx is not None and ctx.kind == "node" and (
                src_name == ctx.var or src_name in ctx.aliases):
            pm = ctx.mask                                   # [L]
            if o_halo:
                pmh = self._with_halo(pm)
                mask = mask & pmh[o_lp]
            else:
                mask = mask & pm[jnp.clip(o_lp, 0, gl.L - 1)] & \
                    (o_lp < gl.L)
            parent = ctx
        elif ctx is None or ctx.kind == "node":
            v = self._ident(src_name, env, ctx)
            mask = mask & (o_gid == v)
            parent = ctx if (ctx is not None and ctx.kind == "node") \
                else None
        else:
            raise LowerError(
                "nested neighbor iteration not supported in "
                "vertex-sharded lowering (the reference GPS backend "
                "rejects two-hop bodies too)")
        return VEdgeCtx(
            g=gl, layout=layout, outer_var=src_name, inner_var=it.var,
            outer_ids=o_gid, inner_ids=i_gid, mask=mask, parent=parent,
            outer_lpos=o_lp, inner_lpos=i_lp,
            outer_is_halo=o_halo, inner_is_halo=i_halo)

    def _wedge_ctx(self, it, layout, env, ctx):
        raise LowerError(
            "nested neighbor iteration not supported in vertex-sharded "
            "lowering")

    # ---- fused halo prefetch ----------------------------------------------
    def _prefetch_halos(self, it: A.Iterator, parts, env, ctx):
        """Before lowering a neighbor loop/reduce, scan its body for every
        node property read through the loop's *ghost* endpoint and refresh
        all stale halos with one fused exchange (``_ensure_halos``) — so a
        k-property superstep (bc, sssp_path) issues 1 ``all_to_all``, not
        k.  Props the scan misses still refresh lazily (correctness never
        depends on the scan)."""
        if it.iter_type not in ("NBRS", "OUT_NBRS", "IN_NBRS"):
            return
        halo_vars = set()
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            # CSR-direction loop: the iterated-FROM side is the edge
            # source = the remote (halo) endpoint under dst-owner
            # placement; parent node-loop aliases resolve there too
            halo_vars.add(it.source)
            if ctx is not None and getattr(ctx, "kind", "") == "node" \
                    and (it.source == ctx.var
                         or it.source in ctx.aliases):
                halo_vars.add(ctx.var)
                halo_vars.update(ctx.aliases)
        else:                          # IN_NBRS: inner (source) is remote
            halo_vars.add(it.var)
        keys: list = []

        def scan(n):
            if isinstance(n, A.Field) and n.driver in halo_vars:
                loc_dt = self.props.get(n.prop)
                if loc_dt is not None and loc_dt[0] == "N":
                    k = _F + n.prop
                    if k not in keys:
                        keys.append(k)

        for p in parts:
            _walk_ast(p, scan)
        if len(keys) > 1:
            self._ensure_halos(keys, env)

    def _exec_foreach(self, s: A.Foreach, env, ctx):
        self._prefetch_halos(s.iterator, (s.body, s.filter), env, ctx)
        return super()._exec_foreach(s, env, ctx)

    def _reduce_expr(self, e: A.ReduceExpr, env, ctx):
        self._prefetch_halos(e.iterator, (e.body, e.filter), env, ctx)
        return super()._reduce_expr(e, env, ctx)

    # ---- reductions ---------------------------------------------------------
    def _reduce_over_nodes(self, e: A.ReduceExpr, env, nctx: NodeCtx):
        """Node-space reduce: local masked reduce + master-scalar combine
        (the GPS aggregator)."""
        mask = nctx.mask
        if e.filter is not None:
            mask = mask & self.eval(e.filter, env, nctx)
        nctx = nctx.with_mask(mask)
        if e.op == "COUNT" and e.body is None:
            vals = mask.astype(jnp.int32)
        else:
            body = self.eval(e.body, env, nctx)
            if e.op == "COUNT":
                vals = (mask & body).astype(jnp.int32)
            elif e.op in ("EXIST", "ALL", "AND", "OR"):
                vals = body
            else:
                vals = jnp.broadcast_to(jnp.asarray(body), mask.shape)
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND",
              "AVG": "SUM"}.get(e.op, e.op)
        if e.op == "AVG":
            vals = jnp.asarray(vals, _float_dtype())
        dt = jnp.asarray(vals).dtype
        if op in ("AND", "OR"):
            work = jnp.asarray(vals).astype(jnp.int8)
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", jnp.int8)
            work = jnp.where(mask, work, ident)
            red = jnp.min if op == "AND" else jnp.max
            out = self._pcomb(red(work), sub) > 0
            return out
        ident = _identity(op, dt)
        work = jnp.where(mask, vals, ident)
        red = {"SUM": jnp.sum, "MIN": jnp.min, "MAX": jnp.max}.get(op)
        if red is None:
            raise LowerError(f"{op} over nodes not supported in "
                             "vertex-sharded lowering")
        out = self._pcomb(red(work), _SEG_OP[op])
        if e.op == "AVG":
            cnt = self._pcomb(jnp.sum(mask.astype(_float_dtype())), "add")
            out = out / jnp.maximum(cnt, 1)
        return out

    def _reduce_over_edges(self, e: A.ReduceExpr, env, ectx, outer_ctx):
        """Edge-space reduce over the local slab.  Scalar results psum;
        per-vertex results are owner-local (destination side) and are
        returned as [L] owned vectors — never combined across shards."""
        mask = ectx.mask
        if e.filter is not None:
            mask = mask & self.eval(e.filter, env, ectx.with_mask(mask))
        ectx = ectx.with_mask(mask)
        if e.op == "COUNT" and e.body is None:
            vals = mask.astype(jnp.int32)
        else:
            body = self.eval(e.body, env, ectx)
            if e.op == "COUNT":
                vals = (mask & body).astype(jnp.int32)
            else:
                vals = jnp.broadcast_to(jnp.asarray(body), mask.shape)
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        if op in ("AND", "OR"):
            work = vals.astype(jnp.int8)
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", jnp.int8)
            seg = sub
        else:
            sub = _SEG_OP.get(op)
            if sub is None:
                raise LowerError(
                    f"{op} over neighbors not supported in vertex-sharded "
                    "lowering")
            ident = _identity(op, vals.dtype)
            work = vals
            seg = sub
        work = jnp.where(mask, work, ident)
        if ectx.inner_is_edge or ectx.parent is None:
            # whole-edge-set / scalar-source neighborhood -> master scalar
            red = {"add": jnp.sum, "min": jnp.min, "max": jnp.max}[seg]
            out = self._pcomb(red(work), seg)
            if op in ("AND", "OR"):
                out = out > 0
            if e.op == "AVG":
                cnt = self._pcomb(jnp.sum(mask.astype(_float_dtype())),
                                  "add")
                out = out.astype(_float_dtype()) / jnp.maximum(cnt, 1)
            return None, out
        # per-outer-vertex reduction: local sorted reduce when the outer
        # endpoint is the owned (destination) side; reverse message
        # combine when it is the ghost (source) side
        gl = self.g
        if ectx.outer_is_halo:
            per, _t = self._reverse_reduce(work, mask, ectx.outer_lpos,
                                           seg, ident)
        else:
            per = ops.sorted_segment_reduce(work, gl.dst_lpos, gl.csc_off,
                                            gl.L + 1, seg)[:gl.L]
        if op in ("AND", "OR"):
            per = per > 0
        if e.op == "AVG":
            if ectx.outer_is_halo:
                cnt, _t = self._reverse_reduce(
                    mask.astype(_float_dtype()), mask, ectx.outer_lpos,
                    "add", jnp.zeros((), _float_dtype()))
            else:
                cnt = ops.sorted_segment_reduce(
                    mask.astype(_float_dtype()), gl.dst_lpos, gl.csc_off,
                    gl.L + 1, "add")[:gl.L]
            per = per.astype(_float_dtype()) / jnp.maximum(cnt, 1)
        if outer_ctx is not None and outer_ctx.kind == "node" and (
                ectx.outer_var == outer_ctx.var
                or ectx.outer_var in outer_ctx.aliases):
            return per, None
        raise LowerError(
            "per-vertex neighbor reduction outside its node loop is not "
            "supported in vertex-sharded lowering")

    # ---- scalar winner agreement -------------------------------------------
    def _ctx_order(self, ctx):
        """A globally-unique, shard-consistent order key per context slot
        (deterministic winner selection across shards)."""
        if ctx.kind == "node":
            return ctx.ids                   # global vertex id
        # match the single-device tie-break: first achiever in the
        # ITERATED layout's slot order
        return self.g.csr_slot if ctx.layout == "csr" else self.g.gslot

    def _exec_assign(self, s: A.Assign, env, ctx):
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            raise LowerError("maps not supported in vertex-sharded "
                             "lowering")
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if dt is not None:
                val = _coerce(val, dt)
            if ctx is not None and lhs.name not in ctx.locals and \
                    lhs.name in env and not (
                        isinstance(env[lhs.name], jax.Array)
                        and env[lhs.name].ndim >= 1):
                # scalar WW race: deterministic lowest-GLOBAL-order
                # winner, agreed across shards
                vv = jnp.asarray(val)
                cur = _coerce(jnp.asarray(env[lhs.name]), vv.dtype)
                any_l = jnp.max(jnp.where(ctx.mask, 1, 0).astype(jnp.int8))
                anyg = self._pcomb(any_l, "max") > 0
                if vv.ndim == 0:
                    self._wr(env, lhs.name, jnp.where(anyg, vv, cur))
                    return
                order = self._ctx_order(ctx)
                big = jnp.asarray(INT32_MAX, jnp.int32)
                cand = jnp.where(ctx.mask, order.astype(jnp.int32), big)
                loc_best = jnp.min(cand)
                glob_best = self._pcomb(loc_best, "min")
                have = (loc_best == glob_best) & (loc_best < big)
                local_val = vv[jnp.argmin(cand)]
                wide = (local_val.astype(_float_dtype())
                        if jnp.issubdtype(vv.dtype, jnp.floating)
                        else local_val.astype(jnp.int32))
                wide = jnp.where(have, wide, 0)
                wide = jax.lax.psum(wide, self.axis)
                win = (wide > 0) if vv.dtype == jnp.bool_ \
                    else wide.astype(vv.dtype)
                self._wr(env, lhs.name, jnp.where(anyg, win, cur))
                return
            self._wr(env, lhs.name, val)
            return
        if isinstance(lhs, A.Field):
            self._exec_field_assign(lhs, s.rhs, env, ctx)
            return
        raise LowerError(
            f"assignment to {type(lhs).__name__} not lowerable")

    def _exec_field_assign(self, lhs: A.Field, rhs, env, ctx):
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        gl = self.g
        if lhs.driver in self.graphs:
            # group assignment G.prop = expr
            if loc == "N":
                gid = gl.gid_base + jnp.arange(gl.L, dtype=jnp.int32)
                nctx = NodeCtx(g=gl, var="", ids=gid,
                               mask=gid < gl.num_nodes,
                               aliases=(lhs.driver,))
                val = _coerce(self.eval(rhs, env, nctx), dt)
                self._write_owned(env, key, nctx.mask, val)
            else:
                ectx = self._edge_ctx(
                    A.Iterator(var="", source=lhs.driver,
                               iter_type="EDGES"), env, None)
                val = _coerce(self.eval(rhs, env, ectx), dt)
                val = jnp.broadcast_to(val, arr.shape)
                self._wr(env, key, jnp.where(gl.emask, val, arr))
            return
        if ctx is not None and ctx.kind == "node" and \
                lhs.driver == ctx.var:
            val = _coerce(self.eval(rhs, env, ctx), dt)
            self._write_owned(env, key, ctx.mask, val)
            return
        if ctx is not None and ctx.kind == "edge":
            if loc == "E" and ((ctx.inner_is_edge and
                                lhs.driver == ctx.inner_var)
                               or lhs.driver in ctx.locals):
                val = _coerce(self.eval(rhs, env, ctx), dt)
                val = jnp.broadcast_to(val, arr.shape)
                self._wr(env, key, jnp.where(ctx.mask, val, arr))
                return
            raise LowerError(
                f"write to {lhs.driver}.{lhs.prop} in a neighbor loop is "
                "a random scatter; not supported in vertex-sharded "
                "lowering (the reference GPS backend rejects these too)")
        # self-update pattern x.p = x.p + e -> equivalent reduction
        if ctx is not None and isinstance(rhs, A.BinOp) and \
                rhs.op in ("+", "*") and isinstance(rhs.lhs, A.Field) and \
                rhs.lhs.prop == lhs.prop and rhs.lhs.driver == lhs.driver:
            red = A.ReduceAssign(lhs=lhs, op="SUM" if rhs.op == "+"
                                 else "MULT", rhs=rhs.rhs, bind=None)
            self._exec_reduce_assign(red, env, ctx)
            return
        if ctx is None:
            # scalar global-id driver (root.dist = 0): owner commits
            gid = self._ident(lhs.driver, env, ctx)
            val = _coerce(self.eval(rhs, env, ctx), dt)
            if loc == "E":
                hit = (gl.csr_slot == jnp.asarray(gid, jnp.int32)) & \
                    gl.emask
                self._wr(env, key, jnp.where(
                    hit, jnp.asarray(val, arr.dtype), arr))
                return
            self._wr(env, key, self._owner_write(arr, gid, val))
            self._mark_stale(key)
            return
        raise LowerError(
            f"assignment to {lhs.driver}.{lhs.prop} in a {ctx.kind} "
            "context not supported in vertex-sharded lowering")

    def _exec_reduce_assign(self, s: A.ReduceAssign, env, ctx):
        op = s.op
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            raise LowerError("maps not supported in vertex-sharded "
                             "lowering")
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if ctx is None:
                cur = env[lhs.name]
                self._wr(env, lhs.name,
                         _coerce(_combine(op, cur, val), dt))
                return
            # A local of an ENCLOSING parallel context is a per-lane
            # accumulator; its edge slots live on dst-owner shards, so a
            # correct implementation needs the reverse message-combine
            # the field path has.  Reject with a remedy instead of
            # producing a silently-global sum (GPS-style feasibility
            # check; the Sum()-expression and property-target forms of
            # the same computation distribute fine).
            c = getattr(ctx, "parent", None)
            while c is not None:
                if lhs.name in c.locals:
                    raise LowerError(
                        f"reduction into '{lhs.name}', a local of an "
                        "enclosing parallel loop, is not vertex-"
                        "shardable — rewrite as a Sum/Min/Max(...) "
                        "expression or reduce into a node property")
                c = getattr(c, "parent", None)
            # scalar reduce over a parallel context: local masked reduce,
            # then the master-scalar combine across shards (node space is
            # sharded here, unlike the replicated edge-sharding mode)
            mask = ctx.mask
            vals = jnp.broadcast_to(jnp.asarray(val), mask.shape)
            if op in ("AND", "OR"):
                sub = "min" if op == "AND" else "max"
                ident = _identity("MIN" if op == "AND" else "MAX",
                                  jnp.int8)
                work = jnp.where(mask, vals.astype(jnp.int8), ident)
                red = jnp.min if op == "AND" else jnp.max
                r = self._pcomb(red(work), sub) > 0
            else:
                sub = _SEG_OP.get(op)
                if sub is None:
                    raise LowerError(f"{op}= not supported in "
                                     "vertex-sharded lowering")
                ident = _identity(op, vals.dtype)
                work = jnp.where(mask, vals, ident)
                red = {"add": jnp.sum, "min": jnp.min,
                       "max": jnp.max}[sub]
                r = self._pcomb(red(work), sub)
            cur = env[lhs.name]
            self._wr(env, lhs.name, _coerce(_combine(op, cur, r), dt))
            return
        if not isinstance(lhs, A.Field):
            raise LowerError("reduce target must be scalar or field")
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        gl = self.g
        if ctx is None:
            # scalar global-id driver: owner read-modify-write
            if loc != "N":
                raise LowerError("scalar edge-property reduce not "
                                 "supported in vertex-sharded lowering")
            gid = self._ident(lhs.driver, env, ctx)
            val = self.eval(s.rhs, env, ctx)
            cur = self._owner_read(arr, gid)
            self._wr(env, key, self._owner_write(
                arr, gid, _coerce(_combine(op, cur, val), dt)))
            self._mark_stale(key)
            return
        if ctx.kind == "node" and lhs.driver == ctx.var:
            val = self.eval(s.rhs, env, ctx)
            vv = jnp.broadcast_to(jnp.asarray(val), (gl.L,))
            new = _coerce(_combine(op, arr[:gl.L], vv), dt)
            self._write_owned(env, key, ctx.mask, new)
            return
        if ctx.kind == "node" and loc == "N":
            raise LowerError(
                f"reduce into {lhs.driver}.{lhs.prop} keyed by a computed "
                "node id is a random scatter; not supported in "
                "vertex-sharded lowering (the reference GPS backend "
                "rejects random writes too)")
        if ctx.kind == "edge":
            if loc != "N":
                raise LowerError("edge-property reduce in a neighbor "
                                 "loop not supported in vertex-sharded "
                                 "lowering")
            val = self.eval(s.rhs, env, ctx)
            vals = jnp.broadcast_to(jnp.asarray(val), ctx.mask.shape)
            if op in ("AND", "OR"):
                sub = "min" if op == "AND" else "max"
                ident = _identity("MIN" if op == "AND" else "MAX",
                                  jnp.int8)
                work = jnp.where(ctx.mask, vals.astype(jnp.int8), ident)
            else:
                sub = _SEG_OP.get(op)
                if sub is None:
                    raise LowerError(f"{op}= over neighbors not "
                                     "supported")
                ident = _identity(op, vals.dtype)
                work = jnp.where(ctx.mask, vals, ident)
            if lhs.driver == ctx.inner_var:
                keys, is_halo = ctx.inner_lpos, ctx.inner_is_halo
            elif lhs.driver == ctx.outer_var or (
                    ctx.parent is not None and (
                        lhs.driver == ctx.parent.var
                        or lhs.driver in ctx.parent.aliases)):
                keys, is_halo = ctx.outer_lpos, ctx.outer_is_halo
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from edge ctx")
            if is_halo:
                # write "against" the edge placement: combine per ghost
                # position and ship partials back to the owner (the GPS
                # message-combiner path)
                seg, touched = self._reverse_reduce(
                    work, ctx.mask, keys, sub, ident)
            else:
                segf = {"add": ops.segment_sum, "min": ops.segment_min,
                        "max": ops.segment_max}[sub]
                seg = segf(work, keys, gl.L + 1, sorted_ids=True)[:gl.L]
                touched = ops.segment_max(
                    ctx.mask.astype(jnp.int8), keys, gl.L + 1,
                    sorted_ids=True)[:gl.L] > 0
            if op in ("AND", "OR"):
                new = _combine(op, arr[:gl.L], seg > 0)
            else:
                new = _coerce(_combine(op, arr[:gl.L],
                                       seg.astype(arr.dtype)), dt)
            self._write_owned(env, key, touched, new)
            return
        raise LowerError("unsupported reduce-assign placement in "
                         "vertex-sharded lowering")

    def _exec_defer(self, s: A.DeferAssign, env, ctx):
        if ctx is None:
            self._exec_assign(A.Assign(lhs=s.lhs, rhs=s.rhs), env, ctx)
            return
        if not isinstance(s.lhs, A.Field):
            raise LowerError("deferred write target must be a field")
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        gl = self.g
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        if ctx.kind == "node" and s.lhs.driver == ctx.var:
            # pad [L]-space mask/value to the [Lh] slab the generic
            # defer-apply loop writes (halo stays untouched -> stale)
            vfull = jnp.zeros((gl.n_pad,), dt)
            vfull = vfull.at[:gl.L].set(
                jnp.broadcast_to(val, (gl.L,)).astype(dt))
            mfull = jnp.zeros((gl.n_pad,), jnp.bool_).at[:gl.L].set(
                ctx.mask)
            pend = (key, mfull, vfull)
            self._mark_stale(key)
        else:
            raise LowerError("deferred write outside its bound node loop "
                             "not lowerable yet")
        if not self._defer_stack:
            raise LowerError("deferred write outside any loop")
        bind = s.bind
        for name, lst in reversed(self._defer_stack):
            if bind is None or name == bind:
                lst.append(pend)
                return
        self._defer_stack[-1][1].append(pend)

    # ---- argmin/argmax ------------------------------------------------------
    def _exec_argminmax(self, s, env, ctx):
        is_min = s.op == "MIN"
        if ctx is None or ctx.kind == "node" or isinstance(s.lhs, A.Ident):
            self._argminmax_scalar_or_node(s, env, ctx, is_min)
            return
        if not isinstance(s.lhs, A.Field) or s.lhs.driver != ctx.inner_var:
            raise LowerError("argmin/argmax target must be keyed by the "
                             "neighbor variable in a neighbor loop")
        if ctx.inner_is_halo:
            raise LowerError(
                "argmin/argmax into the ghost (source) endpoint of an "
                "InNbrs loop — iterate Nbrs instead")
        gl = self.g
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        old = env[key]
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        vals = jnp.broadcast_to(val, ctx.mask.shape)
        ident = _identity("MIN" if is_min else "MAX", dt)
        work = jnp.where(ctx.mask, vals, ident)
        segf = ops.segment_min if is_min else ops.segment_max
        m = segf(work, ctx.inner_lpos, gl.L + 1, sorted_ids=True)[:gl.L]
        old_l = old[:gl.L]
        improved = (m < old_l) if is_min else (m > old_l)
        self._write_owned(env, key, improved, m)
        if not s.lhs_extra:
            return
        # payload select: each destination is owned by exactly one shard,
        # so the winner (lowest local slot among achievers) needs no
        # cross-shard agreement — simpler than the edge-sharding mode
        extra_vals = [self.eval(r, env, ctx) for r in s.rhs_extra]
        need_slot = any(jnp.asarray(v).ndim >= 1 for v in extra_vals)
        win_slot = None
        if need_slot:
            slot_ids = jnp.arange(gl.e_pad, dtype=jnp.int32)
            win = ctx.mask & (work == m[jnp.clip(ctx.inner_lpos, 0,
                                                 gl.L - 1)])
            cand = jnp.where(win, slot_ids,
                             jnp.asarray(gl.e_pad, jnp.int32))
            win_slot = ops.segment_min(cand, ctx.inner_lpos, gl.L + 1,
                                       sorted_ids=True)[:gl.L]
            win_slot = jnp.minimum(win_slot, gl.e_pad - 1)
        for lhs_e, rhs_v in zip(s.lhs_extra, extra_vals):
            if not isinstance(lhs_e, A.Field) or \
                    lhs_e.driver != ctx.inner_var:
                raise LowerError("argminmax payload target must be keyed "
                                 "by the same neighbor variable")
            eloc, edt = self.props[lhs_e.prop]
            if eloc != "N":
                raise LowerError("edge-property argminmax payload not "
                                 "supported in vertex-sharded lowering")
            ekey = _F + lhs_e.prop
            rv = jnp.asarray(rhs_v)
            if rv.ndim >= 1:
                payload = _coerce(rv, edt)[win_slot]
            else:
                payload = jnp.broadcast_to(_coerce(rv, edt), (gl.L,))
            eold = env[ekey]
            self._write_owned(env, ekey, improved, payload)

    def _argminmax_scalar_or_node(self, s, env, ctx, is_min):
        if ctx is None:
            raise LowerError("scalar argminmax outside a loop")
        if not isinstance(s.lhs, A.Ident):
            raise LowerError("scalar argminmax target must be an ident")
        dt = self._target_dtype(s.lhs, env)
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        vals = jnp.broadcast_to(val, ctx.mask.shape)
        ident = _identity("MIN" if is_min else "MAX", dt)
        work = jnp.where(ctx.mask, vals, ident)
        loc_best = jnp.min(work) if is_min else jnp.max(work)
        best = self._pcomb(loc_best, "min" if is_min else "max")
        cur = env[s.lhs.name]
        improved = (best < cur) if is_min else (best > cur)
        self._wr(env, s.lhs.name, jnp.where(improved, best, cur))
        if not s.lhs_extra:
            return
        # winner agreement: among achieving slots, lowest global order
        # key wins; psum-select its payload (exactly one shard holds it)
        order = self._ctx_order(ctx).astype(jnp.int32)
        big = jnp.asarray(INT32_MAX, jnp.int32)
        achieves = ctx.mask & (work == best)
        cand = jnp.where(achieves, order, big)
        loc_ord = jnp.min(cand)
        glob_ord = self._pcomb(loc_ord, "min")
        have = (loc_ord == glob_ord) & (loc_ord < big)
        idx = jnp.argmin(cand)
        for lhs_e, rhs_e in zip(s.lhs_extra, s.rhs_extra):
            if not isinstance(lhs_e, A.Ident):
                raise LowerError("scalar argminmax payload must be ident")
            pv = jnp.asarray(self.eval(rhs_e, env, ctx))
            pick = pv[idx] if pv.ndim >= 1 else pv
            edt = self._target_dtype(lhs_e, env)
            if edt is not None:
                pick = _coerce(pick, edt)
            wide = (pick.astype(_float_dtype())
                    if jnp.issubdtype(jnp.asarray(pick).dtype,
                                      jnp.floating)
                    else pick.astype(jnp.int32))
            wide = jnp.where(have, wide, 0)
            wide = jax.lax.psum(wide, self.axis)
            agreed = (wide > 0) if jnp.asarray(pick).dtype == jnp.bool_ \
                else wide.astype(jnp.asarray(pick).dtype)
            self._wr(env, lhs_e.name, jnp.where(improved, agreed,
                                                env[lhs_e.name]))

    # ---- feasibility rejections --------------------------------------------
    def _exec_vardecl(self, s, env, ctx):
        t = s.type
        if t.kind in ("NSET", "NSEQ", "NORDER", "MAP") or (
                t.is_property() and getattr(t.elem, "kind", None)
                == "NSET"):
            raise LowerError(
                f"collections/maps not supported in vertex-sharded "
                "lowering (node-set state is not vertex-partitionable "
                "yet)")
        return super()._exec_vardecl(s, env, ctx)

    def _exec_bfs(self, s, env, ctx):
        """InBFS under vertex sharding: level-sync frontier expansion
        over the owned slab with one ghost exchange per level (the GPS
        ``transform_bfs`` level-sync rewrite), then a traced per-level
        replay of the forward/reverse bodies.  InDFS stays rejected
        (inherently sequential; the reference GPS backend rejects it
        too)."""
        if not s.is_bfs:
            raise LowerError("InDFS not supported in vertex-sharded "
                             "lowering (inherently sequential)")
        if ctx is not None:
            raise LowerError("InBFS nested inside a parallel loop")
        gl = self.g
        root = self._ident(s.root, env, None)
        gid = gl.gid_base + jnp.arange(gl.L, dtype=jnp.int32)
        owned = gid < gl.num_nodes
        allowed = None
        if s.navigator is not None:
            nctx = NodeCtx(g=gl, var=s.var, ids=gid, mask=owned)
            allowed = jnp.broadcast_to(
                jnp.asarray(self.eval(s.navigator, env, nctx)),
                (gl.L,)).astype(jnp.bool_)
        level, depth = self._bfs_levels(root, s.transpose, allowed)
        env["__bfs_level$" + s.var] = level
        self._replay_bfs(s, env, level, depth, gid, owned)

    def _bfs_levels(self, root, transpose: bool, allowed):
        gl = self.g
        INF = jnp.asarray(INT32_MAX, jnp.int32)
        gid = gl.gid_base + jnp.arange(gl.L, dtype=jnp.int32)
        mask = gid < gl.num_nodes
        if allowed is not None:
            mask = mask & allowed
        rootv = jnp.asarray(root, jnp.int32)
        level0 = jnp.where((gid == rootv) & (gid < gl.num_nodes),
                           jnp.int32(0), INF)
        level0 = jnp.where(mask | (gid == rootv), level0, INF)

        def cond(st):
            return st[1]

        def body(st):
            level, _, d = st
            fr = (level == d) & mask                       # [L] owned
            if transpose:
                # BFS over G^: v joins when some OUT-neighbor w is in
                # the frontier.  Edge v->w sits on w's owner (dst
                # side), so the per-v reduction is a reverse message
                # combine back to v's owner.
                dst_ok = fr[jnp.clip(gl.dst_lpos, 0, gl.L - 1)] & \
                    (gl.dst_lpos < gl.L)
                work = jnp.where(gl.emask & dst_ok, jnp.int8(1),
                                 jnp.int8(0))
                reach_l, _t = self._reverse_reduce(
                    work, gl.emask & dst_ok, gl.src_lpos, "max",
                    jnp.int8(0))
                reach = reach_l > 0
            else:
                frh = self._with_halo(fr)
                vals = jnp.where(gl.emask, frh[gl.src_lpos],
                                 False).astype(jnp.int8)
                reach = ops.segment_max(vals, gl.dst_lpos, gl.L + 1,
                                        sorted_ids=True)[:gl.L] > 0
            newly = reach & (level == INF) & mask
            level2 = jnp.where(newly, d + 1, level)
            any_new = jax.lax.psum(
                jnp.sum(newly.astype(jnp.int32)), self.axis) > 0
            return level2, any_new, d + 1

        level, _, depth = jax.lax.while_loop(
            cond, body, (level0, jnp.asarray(True),
                         jnp.asarray(0, jnp.int32)))
        return level, depth

    def _replay_bfs(self, s, env, level, depth, gid, owned):
        """Traced per-level replay (the shard-map twin of
        lower_bfs._replay_traced, over [L] owned contexts)."""
        from .lower import (_DONE, _RET, _RNG, declared_keys, uses_rng,
                            written_keys)

        def run_phase(body, filt, reverse):
            if body is None:
                return
            wkeys = written_keys(body)
            if uses_rng(body):
                raise LowerError("RNG inside a sharded InBFS body")
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
                m = owned & (level == d)
                nctx = NodeCtx(g=self.g, var=s.var, ids=gid, mask=m)
                if s.navigator is not None and not reverse:
                    nctx = nctx.with_mask(nctx.mask & jnp.broadcast_to(
                        jnp.asarray(self.eval(s.navigator, e2, nctx)),
                        m.shape))
                if filt is not None:
                    nctx = nctx.with_mask(nctx.mask & jnp.broadcast_to(
                        jnp.asarray(self.eval(filt, e2, nctx)),
                        m.shape))
                self._bfs_ctx = (s.var, level, d)
                try:
                    self._defer_stack.append((s.var, []))
                    try:
                        self.exec_stmt(body, e2, nctx)
                    finally:
                        _, pend = self._defer_stack.pop()
                    for key, mask, val in pend:
                        self._wr(e2, key, jnp.where(mask, val, e2[key]))
                finally:
                    self._bfs_ctx = None
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

    def _exec_for_items(self, s, env, ctx):
        raise LowerError("collection iteration not supported in "
                         "vertex-sharded lowering")

    def _exec_for_nbrs_eager(self, s, env):
        raise LowerError("sequential neighbor loop not supported in "
                         "vertex-sharded lowering")

    def _exec_for_nodes_eager(self, s, env):
        raise LowerError("sequential node loop not supported in "
                         "vertex-sharded lowering")

    def _exec_while_eager(self, s, env, max_iters=1_000_000):
        raise LowerError("host-eager While not supported in "
                         "vertex-sharded lowering")

    def _exec_while(self, s, env, ctx):
        from .lower import contains_bfs
        if ctx is None and contains_bfs(s.body) and \
                not (self._uses_map(s.body) or self._uses_map(s.cond)):
            # the vmode BFS replay is fully traced, so BFS-containing
            # While loops take the ordinary lax.while_loop path (the
            # single-device lowering must host-replay them instead)
            return self._exec_while_traced(s, env)
        return super()._exec_while(s, env, ctx)


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------

def _default_mesh(axis: str, n: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n is None:
        n = len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def run_vertex_sharded(cp: CompiledProc, g: Graph, *args,
                       mesh: Optional[Mesh] = None, axis: str = "v",
                       sched: Optional[VertexSchedule] = None,
                       stats: Optional[Dict] = None,
                       placements: Optional[Dict[str, str]] = None,
                       **kwargs) -> Dict:
    """Execute a compiled procedure vertex-sharded over ``mesh[axis]``.

    Same call convention and result dict as ``cp(g, *args, **kwargs)``;
    node-property results come back in global [N_pad] layout.  Per-shard
    node state is O(N/S) + O(cut) — the compiled analog of the GPS
    backend's vertex partitioning.  Pass a prebuilt ``sched`` to amortize
    the host partition build across calls.

    ``placements`` is the per-array user override (Shoal's
    ``local_array_settings.lua``, ``scripts/run.sh:218-246`` +
    ``generate_settings.py``): ``{array_name: "replicate"|"distribute"}``.
    ``distribute`` is the automatic decision (owned O(N/S) slab + ghost
    halo).  ``replicate`` pins a READ-ONLY input node property to full
    per-device addressability: its halo slots are pre-filled at bind
    time and stay permanently fresh, so it never rides the superstep
    ``all_to_all`` — the device-mesh meaning of a per-socket replicated copy.
    Written properties and edge properties reject with ``LowerError``
    (a replicated written copy would diverge; edge arrays define the
    partition itself).
    """
    if mesh is None:
        mesh = _default_mesh(axis)
    S = mesh.shape[axis]
    if sched is None:
        sched = place_schedule(build_schedule(g, S), mesh, axis)

    # ---- host-side argument walk (mirrors CompiledProc._bind) ----------
    lw0 = Lowerer(cp.proc, g, axis=None)
    pos = list(args)
    graph_names = []
    nprops: Dict[str, Tuple[object, object]] = {}
    eprops: Dict[str, Tuple[object, object]] = {}
    scalars: Dict[str, jax.Array] = {}
    alloc = []                      # (name, loc, dt) to allocate in-body
    out_names = []
    prop_loc: Dict[str, str] = {}

    def bind_prop(name, val):
        loc, dt = lw0.props[name]
        if dt == "NSET":
            raise LowerError("N_P<Node_Set> not supported in "
                             "vertex-sharded lowering")
        prop_loc[name] = loc
        if loc == "N":
            nprops[name] = (val, dt)
        else:
            eprops[name] = (val, dt)

    for decl in cp.proc.args:
        for name in decl.names:
            if decl.type.kind == "GRAPH":
                graph_names.append(name)
                continue
            if decl.type.kind in ("NSET", "NSEQ", "NORDER", "MAP") or \
                    decl.type.is_collection():
                raise LowerError(
                    f"collection argument {name} not supported in "
                    "vertex-sharded lowering")
            if name in kwargs:
                val = kwargs[name]
            elif pos:
                val = pos.pop(0)
            elif decl.type.is_property():
                loc, dt = lw0.props[name]
                if dt == "NSET":
                    raise LowerError("N_P<Node_Set> not supported in "
                                     "vertex-sharded lowering")
                prop_loc[name] = loc
                out_names.append(name)
                alloc.append((name, loc, dt))
                continue
            else:
                raise TypeError(f"missing argument {name}")
            if decl.type.is_property():
                bind_prop(name, val)
            else:
                scalars[name] = _coerce(
                    jnp.asarray(val), dtype_of_kind(decl.type.kind))
    for decl in cp.proc.out_args:
        for name in decl.names:
            out_names.append(name)
            if decl.type.is_property():
                if name in kwargs:
                    bind_prop(name, kwargs[name])
                else:
                    loc, dt = lw0.props[name]
                    prop_loc[name] = loc
                    alloc.append((name, loc, dt))
            else:
                scalars[name] = _coerce(
                    jnp.asarray(kwargs.get(name, 0)),
                    dtype_of_kind(decl.type.kind))

    # ---- per-array user overrides (validated against the bound set) ----
    repl_names = set()
    wkeys = written_keys(cp.proc.body) if placements else ()
    for name, pol in (placements or {}).items():
        pol = str(pol).lower()
        if pol not in ("replicate", "distribute"):
            raise LowerError(
                f"unknown placement policy '{pol}' for array "
                f"'{name}' (replicate|distribute)")
        if name not in nprops and name not in eprops:
            known = sorted(list(nprops) + list(eprops)) or ["<none>"]
            raise LowerError(
                f"placement override names unknown array '{name}' "
                f"(bound input properties: {', '.join(known)})")
        if pol == "distribute":
            continue            # the automatic decision; accepted as-is
        if name in eprops:
            raise LowerError(
                f"edge property '{name}' cannot be replicated: the "
                "edge arrays define the vertex partition itself")
        if (_F + name) in wkeys:
            raise LowerError(
                f"array '{name}' is written by {cp.proc.name} — a "
                "replicated copy would diverge across shards; only "
                "read-only inputs can be replicated")
        repl_names.add(name)

    # ---- slab conversion (device-side, respects schedule sharding) -----
    L, Es, Gh = sched.L, sched.E_s, sched.G
    N = g.num_nodes

    nslabs = {}
    for name, (val, dt) in nprops.items():
        a = _coerce(jnp.asarray(val), dt)
        tot = S * L
        if a.shape[0] < tot:
            a = jnp.pad(a, (0, tot - a.shape[0]))
        owned = a[:tot].reshape(S, L)
        if name in repl_names and Gh > 0:
            # replicate: pre-fill the halo from the global array so the
            # property never needs a superstep exchange (sentinel slots
            # clip to a valid index; they are never read by real edges)
            halo = a[jnp.clip(sched.ghost_gid, 0, tot - 1)]   # [S, G]
            nslabs[name] = jnp.concatenate([owned, halo], axis=1)
        else:
            nslabs[name] = owned
    eslabs = {}
    for name, (val, dt) in eprops.items():
        a = _coerce(jnp.asarray(val), dt)
        if a.shape[0] < g.e_pad:
            a = jnp.pad(a, (0, g.e_pad - a.shape[0]))
        slab = a[jnp.clip(sched.csr_slot, 0, a.shape[0] - 1)]
        eslabs[name] = jnp.where(sched.emask, slab,
                                 jnp.zeros((), a.dtype))
    has_ret = _RET in written_keys(cp.proc.body)

    def body(sch: VertexSchedule, nsl, esl, scal):
        def sq(x):
            return x.reshape(x.shape[1:])
        t = jax.lax.axis_index(axis)
        gl = LocalView(
            sched, gid_base=t.astype(jnp.int32) * jnp.int32(L),
            dst_lpos=sq(sch.dst_lpos), src_lpos=sq(sch.src_lpos),
            src_gid=sq(sch.src_gid), emask=sq(sch.emask),
            csr_slot=sq(sch.csr_slot), gslot=sq(sch.gslot),
            send_idx=sq(sch.send_idx), send_mask=sq(sch.send_mask),
            ghost_gid=sq(sch.ghost_gid),
            deg_out=sq(sch.deg_out), deg_in=sq(sch.deg_in),
            csc_off=sq(sch.csc_off))
        lw = VertexLowerer(cp.proc, gl, axis=axis)
        env: Dict = {}
        for gn in graph_names:
            env[gn] = gl
        for name, slab in nsl.items():
            dt = slab.dtype
            if name in repl_names and Gh > 0:
                # replicated (user-pinned): halo pre-filled at bind
                # time; mark it permanently fresh so no exchange ever
                # carries this property
                arr = sq(slab)
                env[_F + name] = arr
                lw._halo_ok[_F + name] = arr
            else:
                env[_F + name] = jnp.concatenate(
                    [sq(slab), jnp.zeros((Gh,), dt)])
        for name, slab in esl.items():
            env[_F + name] = sq(slab)
        for name, v in scal.items():
            env[name] = v
        for name, loc, dt in alloc:
            env[_F + name] = (gl.node_prop(0, dt) if loc == "N"
                              else gl.edge_prop(0, dt))
        lw.run(env)
        if stats is not None:
            # trace-time op count: how many all_to_all exchange launches
            # the compiled program contains (test hook for the fused
            # congruent-message guarantee)
            stats["exchanges"] = lw.exchange_count
        outs = {}
        for name in out_names:
            if prop_loc.get(name) == "N":
                outs[name] = env[_F + name][:L]
            elif prop_loc.get(name) == "E":
                outs[name] = env[_F + name]
            else:
                outs[name] = env.get(name)
        if has_ret:
            outs["_return"] = env[_RET]
        return outs

    out_specs = {}
    for name in out_names:
        out_specs[name] = P(axis) if prop_loc.get(name) in ("N", "E") \
            else P()
    if has_ret:
        out_specs["_return"] = P()

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis, None), P(axis, None), P()),
        out_specs=out_specs, check_vma=False)
    out = fn(sched, nslabs, eslabs, scalars)

    # node-prop outputs arrive as [S*L] global slabs -> [N_pad] layout;
    # edge-prop outputs as [S*E_s] slabs -> scatter back to CSR order
    res = {}
    for name, v in out.items():
        if prop_loc.get(name) == "N":
            res[name] = jnp.concatenate(
                [v[:N], jnp.zeros((g.n_pad - N,), v.dtype)])
        elif prop_loc.get(name) == "E":
            tgt = jnp.where(sched.emask, sched.csr_slot,
                            jnp.asarray(g.e_pad, jnp.int32)).reshape(-1)
            res[name] = jnp.zeros((g.e_pad + 1,), v.dtype).at[tgt].set(
                v.reshape(-1))[:g.e_pad]
        else:
            res[name] = v
    return res


def placement_report(sched: VertexSchedule, n_props: int = 1,
                     placements: Optional[Dict[str, str]] = None) -> str:
    """Per-array placement table for the compiled distributed path (the
    Shoal decision-table analog, ``gm_cpp_gen.cc:229-305``).
    ``placements`` adds one row per user-pinned array
    (``local_array_settings.lua`` analog)."""
    rows = []
    S = sched.num_shards
    for f in ("dst_lpos", "src_lpos", "src_gid", "emask", "csr_slot",
              "send_idx", "deg_out", "csc_off"):
        a = getattr(sched, f)
        per_dev = (a.size // S) * a.dtype.itemsize
        shp = "x".join(str(d) for d in a.shape)
        rows.append(f"Array[{f}]: elements={a.size} global={shp} "
                    f"bytes/device={per_dev} -- "
                    f"replication=[ ] distribution=[X]")
    rows.append(f"Array[node_prop]: elements={S * sched.Lh} "
                f"global={S}x{sched.Lh} "
                f"bytes/device={sched.Lh * 4} -- "
                f"replication=[ ] distribution=[X] "
                f"(owned={sched.L} + halo={sched.G})")
    for name, pol in sorted((placements or {}).items()):
        rep = str(pol).lower() == "replicate"
        per_dev = (sched.Lh if rep else sched.L) * 4
        rows.append(f"Array[{name}]: elements={S * sched.L} "
                    f"global={S}x{sched.L} bytes/device={per_dev} -- "
                    f"replication=[{'X' if rep else ' '}] "
                    f"distribution=[{' ' if rep else 'X'}] "
                    "(pinned by user"
                    + (", halo pre-filled, no exchange)" if rep else ")"))
    rows.append(f"# ghost exchange: total={sched.ghost_total} ids, "
                f"cap={sched.cap}/pair, "
                f"bytes/superstep/device={S * sched.cap * 4}")
    return "\n".join(rows)
