"""Lowering: typechecked Green-Marl AST -> jitted JAX array program.

This is the JAX replacement for the reference's entire back half —
the backend-independent optimizer (``src/opt/``) and the C++/OpenMP code
generator (``src/backend_cpp/gm_cpp_gen.cc``).  Instead of emitting C++
source with ``#pragma omp parallel for`` over CSR ranges and atomic/lock
reductions, we *vectorize* the AST directly into JAX:

==========================  =================================================
reference construct          JAX lowering
==========================  =================================================
``Foreach(n: G.Nodes)``      masked dense ops over the padded node axis
                             (``gm_cpp_gen.cc:1021-1072`` OpenMP loop)
``Foreach(s: n.Nbrs)`` +     gather over CSR/CSC slots + fixed-order segment
reduction                    reduction (``gm_cpp_gen_foreach.cc:33-328`` +
                             atomics ``gm_cpp_gen.cc:1526-1561``)
``x min= v @ n`` / argminmax scatter-free ``segment_min`` + win-mask payload
                             select (spinlock argmin ``gm_cpp_gen.cc:
                             1563-1742``)
``t.p <= v @ t`` (defer)     pending write applied at loop exit — the
                             double-buffering the defer opt creates
                             (``gm_cpp_opt_defer.cc``)
``Do/While``                 ``lax.while_loop`` whose carry is the statically
                             computed write-set of the body (reaching-defs
                             equivalent, ``gm_reaching_def_analysis.cc``)
``If`` (scalar)              both branches traced + ``where`` merge
``If`` (inside Foreach)      mask refinement
reductions ``Sum/Min/...``   masked ``jnp``/segment reductions — determinism
                             by construction (no race oracle needed at run
                             time; cf. ``gm_rw_analysis.cc``)
==========================  =================================================

Parallelism policy mirrors ``gm_cpp_opt_select_par.cc:27-108``: the
outermost node/edge loop is the parallel (vectorized) one; nested neighbor
loops become the per-segment axis of a segment reduction.  Sequential
``For`` over nodes is lowered the same way when every statement in its body
is order-independent (a reduction or a disjoint write); order-dependent
sequential loops raise ``LowerError`` (the reference backend's
``check_feasible`` analog, ``gm_cpp_opt_check_feasible.cc``).

dtype mapping (x64 off): INT/LONG -> int32, FLOAT/DOUBLE -> float32
(float64 if jax x64 is enabled), BOOL -> bool, NODE/EDGE -> int32.
``INF`` follows the reference's saturation semantics (INT_MAX etc.,
``gm_main.cc`` / ``gm_defs.h``): coercion clamps infinities to the integer
dtype's extrema.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import gm_ast as A
from .typecheck import typecheck
from ..graph.csr import Graph
from ..ops import segment as ops


class _CtxMapHist:
    """``Map<Node, Int>`` declared inside a parallel node loop
    (communities.gm): one logical histogram per outer node.  Increments
    recorded in edge space are reduced on demand into per-outer-node
    (max count, arg-max key, count-of-key) vectors via a composite-key
    sort + run-length encoding — the scatter-free formulation of the
    reference's per-iteration hash map (``gm_map.h``).

    Tie-breaks pick the smallest key (the reference's hash-iteration
    order is unspecified); an empty histogram reports HasMaxValue=True
    (no evidence against the queried key — keeps label propagation from
    diverging on isolated nodes).
    """

    def __init__(self, n_pad: int):
        self.n_pad = n_pad
        self.entries = []    # (keys, weights, mask, outer_ids)
        self.cache = None

    def _runs(self):
        if self.cache is not None:
            return self.cache
        if not self.entries:
            raise LowerError("per-node map read before any increment")
        n_pad = self.n_pad
        xs, labs, ws = [], [], []
        for k, v, mask, outer in self.entries:
            xs.append(jnp.where(mask, outer, n_pad).astype(jnp.int32))
            labs.append(jnp.where(mask, k, n_pad).astype(jnp.int32))
            ws.append(jnp.where(mask, v, 0).astype(jnp.int32))
        x = jnp.concatenate(xs)
        lab = jnp.concatenate(labs)
        w = jnp.concatenate(ws)
        x_s, lab_s, w_s = jax.lax.sort((x, lab, w), num_keys=2)
        S = x_s.shape[0]
        prev_x = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                  x_s[:-1]])
        prev_l = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                  lab_s[:-1]])
        change = (x_s != prev_x) | (lab_s != prev_l)
        run_id = jnp.cumsum(change.astype(jnp.int32)) - 1
        counts = jax.ops.segment_sum(w_s, run_id, num_segments=S,
                                     indices_are_sorted=True)
        run_x = jax.ops.segment_max(x_s, run_id, num_segments=S,
                                    indices_are_sorted=True)
        run_lab = jax.ops.segment_max(lab_s, run_id, num_segments=S,
                                      indices_are_sorted=True)
        valid = (run_x < n_pad) & (run_lab < n_pad) & (counts > 0)
        counts = jnp.where(valid, counts, 0)
        seg = jnp.where(valid, run_x, n_pad)
        maxc = jax.ops.segment_max(counts, seg,
                                   num_segments=n_pad + 1)[:n_pad]
        maxc = jnp.maximum(maxc, 0)
        is_best = valid & (counts == maxc[jnp.minimum(run_x, n_pad - 1)])
        maxkey = jax.ops.segment_min(
            jnp.where(is_best, run_lab, jnp.iinfo(jnp.int32).max),
            seg, num_segments=n_pad + 1)[:n_pad]
        self.cache = (seg, run_lab, counts, valid, maxc, maxkey)
        return self.cache

    def max_count(self):
        return self._runs()[4]

    def max_key(self):
        """[n_pad] arg-max key per outer node (smallest on ties);
        INT32_MAX where the histogram is empty."""
        return self._runs()[5]

    def count_of(self, kvec):
        seg, run_lab, counts, valid, _, _ = self._runs()
        n_pad = self.n_pad
        kv = jnp.asarray(kvec)
        hit = valid & (run_lab == kv[jnp.minimum(seg, n_pad - 1)])
        return jax.ops.segment_max(
            jnp.where(hit, counts, 0), seg,
            num_segments=n_pad + 1)[:n_pad]

    def has_max_value(self, kvec):
        maxc = self.max_count()
        return (maxc == 0) | (self.count_of(kvec) == maxc)


class RaceWarning(UserWarning):
    """A parallel write-write/read-write conflict detected by RW analysis.

    Mirrors the reference's ``gm_rw_analysis_check2.cc`` conflict report,
    where WW/RW conflicts are warnings (``is_warning = true``) and
    compilation proceeds with last-store-wins semantics; our lowering
    substitutes a deterministic lowest-slot winner."""


class LowerError(Exception):
    """Construct outside the lowerable subset (cf. check_feasible)."""


# --------------------------------------------------------------------------
# dtype machinery
# --------------------------------------------------------------------------

def _float_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def dtype_of_kind(kind: str):
    if kind in ("INT", "LONG", "NODE", "EDGE"):
        return jnp.int32
    if kind in ("FLOAT", "DOUBLE"):
        return _float_dtype()
    if kind == "BOOL":
        return jnp.bool_
    raise LowerError(f"no dtype for type kind {kind}")


def _alloc_prop(g: "Graph", loc: str, dt):
    """Allocate an unsupplied property argument.

    ``dt == "NSET"`` is an ``N_P<Node_Set>`` (potential_friends.gm):
    represented as an [N_pad, N_pad] bit matrix — same O(N * set)
    worst-case memory as the reference's gm_property_of_collection of
    bitmap sets, with an explicit scale guard."""
    if dt == "NSET":
        if g.n_pad > 8192:
            raise LowerError(
                "N_P<Node_Set> bit-matrix limited to 8192 nodes")
        return jnp.zeros((g.n_pad, g.n_pad), jnp.bool_)
    return g.node_prop(0, dt) if loc == "N" else g.edge_prop(0, dt)


def _coerce(val, dtype):
    """Cast honoring the reference's INF saturation: +/-inf -> int extrema."""
    val = jnp.asarray(val)
    if jnp.issubdtype(dtype, jnp.integer) and jnp.issubdtype(
            val.dtype, jnp.floating):
        info = jnp.iinfo(dtype)
        val = jnp.where(jnp.isposinf(val), float(info.max), val)
        val = jnp.where(jnp.isneginf(val), float(info.min), val)
    return val.astype(dtype)


def _identity(op: str, dtype):
    """Reduction identity (reference GM_REDUCE_* defaults)."""
    if op in ("SUM", "COUNT", "AVG"):
        return jnp.zeros((), dtype)
    if op == "MULT":
        return jnp.ones((), dtype)
    if op == "MIN":
        if jnp.issubdtype(dtype, jnp.integer):
            return jnp.asarray(jnp.iinfo(dtype).max, dtype)
        return jnp.asarray(jnp.inf, dtype)
    if op == "MAX":
        if jnp.issubdtype(dtype, jnp.integer):
            return jnp.asarray(jnp.iinfo(dtype).min, dtype)
        return jnp.asarray(-jnp.inf, dtype)
    if op in ("AND", "ALL"):
        return jnp.asarray(True)
    if op in ("OR", "EXIST"):
        return jnp.asarray(False)
    raise LowerError(f"no identity for reduce op {op}")


def _combine(op: str, a, b):
    if op == "SUM":
        return a + b
    if op == "MULT":
        return a * b
    if op == "MIN":
        return jnp.minimum(a, b)
    if op == "MAX":
        return jnp.maximum(a, b)
    if op in ("AND", "ALL"):
        return a & b
    if op in ("OR", "EXIST"):
        return a | b
    raise LowerError(f"no combiner for reduce op {op}")


_SEG_OP = {"SUM": "add", "COUNT": "add", "AVG": "add",
           "MIN": "min", "MAX": "max"}


# --------------------------------------------------------------------------
# Vector contexts
# --------------------------------------------------------------------------

@dataclasses.dataclass
class NodeCtx:
    """Body of a node-parallel Foreach: values are [N_pad] vectors."""
    g: Graph
    var: str                      # iteration variable ("" for group assign)
    ids: jax.Array                # [N_pad] iota
    mask: jax.Array               # [N_pad] bool (node_mask & filters)
    aliases: Tuple[str, ...] = ()  # names that also mean `ids` (graph name
    #                               in group-assign expansion, gm_expand_
    #                               group_assignment.cc)
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "node"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)


@dataclasses.dataclass
class EdgeCtx:
    """Nested neighbor loop: values are [E_pad] per-slot vectors."""
    g: Graph
    layout: str                   # "csr" (Nbrs/Edges) | "csc" (InNbrs)
    outer_var: str                # the node whose neighborhood is iterated
    inner_var: str                # the loop variable (neighbor or edge)
    outer_ids: jax.Array          # [E_pad]
    inner_ids: jax.Array          # [E_pad]
    mask: jax.Array               # [E_pad]
    parent: Optional[NodeCtx]
    inner_is_edge: bool = False   # Foreach(e: G.Edges)
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "edge"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)

    def slots(self):
        """CSR slot id per context slot (edge property index)."""
        if self.layout == "csr":
            return jnp.arange(self.g.e_pad, dtype=jnp.int32)
        return self.g.e_rev2idx


@dataclasses.dataclass
class WedgeCtx:
    """Second-hop neighbor iteration flattened to the wedge space.

    Lowers ``Foreach(w: u.Nbrs)`` / ``Sum(w: u.Nbrs){..}`` where ``u`` is
    itself a per-slot value of an enclosing parallel context (the pattern
    the reference rewrites with ``CommonNbrs`` / sorted intersection,
    ``gm_cpp_opt_common_nbr.cc``; wedge enumeration of
    ``triangle_counting.gm``).  Wedge ``w`` belongs to outer context
    position ``sel[w]`` and visits the neighbor at ``slot[w]`` of its
    driver's row.  Built eagerly (sizes depend on the concrete graph), so
    it is unavailable inside traced loops.
    """
    g: Graph
    var: str                      # inner loop variable
    outer_var: str                # driver name
    layout: str                   # second-hop direction: "csr" | "csc"
    sel: jax.Array                # [W] outer ctx position per wedge
    slot: jax.Array               # [W] second-hop slot (layout arrays)
    inner_ids: jax.Array          # [W] neighbor node id
    outer_ids: jax.Array          # [W] driver node id
    mask: jax.Array               # [W]
    parent: object                # enclosing ctx (Node/Edge/Wedge)
    parent_len: int
    parent_offsets: np.ndarray    # [L+1] wedge run offsets per outer pos
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "wedge"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)

    def slots(self):
        """CSR edge-property slot per wedge (ToEdge / edge props)."""
        if self.layout == "csr":
            return self.slot
        return self.g.e_rev2idx[self.slot]


_F = "F$"          # env-key prefix for properties (separate namespace,
#                    mirroring curr_sym/curr_field symtab split)
_RET = "__ret__"
_DONE = "__done__"
_RNG = "__rng$"    # counter-based RNG draw counter (gm_rand.h analog)


# --------------------------------------------------------------------------
# Static write-set / decl-set analysis (while-loop carry discovery)
# --------------------------------------------------------------------------

def _lhs_key(lhs) -> str:
    if isinstance(lhs, A.Ident):
        return lhs.name
    if isinstance(lhs, A.Field):
        return _F + lhs.prop
    if isinstance(lhs, A.MapAccess):
        return lhs.map_name
    raise LowerError(f"unsupported assignment target {type(lhs).__name__}")


def written_keys(stmt) -> Set[str]:
    out: Set[str] = set()

    def walk(s):
        if s is None:
            return
        if isinstance(s, A.Block):
            for x in s.stmts:
                walk(x)
        elif isinstance(s, (A.Assign, A.ReduceAssign, A.DeferAssign)):
            out.add(_lhs_key(s.lhs))
        elif isinstance(s, A.ArgMinMaxAssign):
            out.add(_lhs_key(s.lhs))
            for e in s.lhs_extra:
                out.add(_lhs_key(e))
        elif isinstance(s, A.VarDecl):
            pass
        elif isinstance(s, A.Foreach):
            walk(s.body)
        elif isinstance(s, A.If):
            walk(s.then)
            walk(s.els)
        elif isinstance(s, A.While):
            walk(s.body)
        elif isinstance(s, A.BFS):
            walk(s.body_fw)
            walk(s.body_bw)
        elif isinstance(s, A.Return):
            out.add(_RET)
            out.add(_DONE)
        elif isinstance(s, A.CallStmt):
            # mutating collection verbs write their driver (S.Add(v) etc.)
            c = s.call
            if c.driver is not None and \
                    c.name.lower() in _MUTATE_METHODS:
                out.add(c.driver)
            elif c.driver_field is not None and \
                    c.name.lower() in _MUTATE_METHODS:
                out.add(_F + c.driver_field.prop)
        elif isinstance(s, A.ForeignStmt):
            for m in s.mutated:
                nm = getattr(m, "name", None)
                if nm is not None:
                    out.add(nm)
                elif isinstance(m, A.Field):
                    out.add(_F + m.prop)
        else:
            raise LowerError(f"unknown statement {type(s).__name__}")

    walk(stmt)

    # mutating collection verbs in EXPRESSION position also write their
    # driver (``Node w = Stack.PopBack()`` — tarjan_scc.gm)
    def scan(n):
        if isinstance(n, A.Builtin) and n.driver is not None and \
                n.name.lower() in _MUTATE_METHODS:
            out.add(n.driver)
    _walk_ast(stmt, scan)
    return out


# Collection verbs that mutate their driver (gm_builtin.cc mutate_grow/
# mutate_shrink aux info): a CallStmt on these writes the collection.
_MUTATE_METHODS = {"add", "remove", "clear", "pushback", "pushfront",
                   "popback", "popfront", "push", "pop"}

_RNG_BUILTINS = {"uniform", "rand", "pickrandom", "pickrandomnbr"}


def _walk_ast(node, fn):
    """Generic pre-order walk over AST dataclasses/lists."""
    if node is None:
        return
    fn(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _walk_ast(getattr(node, f.name), fn)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _walk_ast(x, fn)


def uses_rng(node) -> bool:
    found = []

    def fn(n):
        if isinstance(n, A.Builtin) and n.name.lower() in _RNG_BUILTINS:
            found.append(n)
    _walk_ast(node, fn)
    return bool(found)


def contains_bfs(node) -> bool:
    found = []

    def fn(n):
        if isinstance(n, A.BFS):
            found.append(n)
    _walk_ast(node, fn)
    return bool(found)


def declared_keys(stmt) -> Set[str]:
    out: Set[str] = set()

    def walk(s):
        if s is None:
            return
        if isinstance(s, A.Block):
            for x in s.stmts:
                walk(x)
        elif isinstance(s, A.VarDecl):
            for n in s.names:
                out.add(_F + n if s.type.is_property() else n)
        elif isinstance(s, A.Foreach):
            walk(s.body)
        elif isinstance(s, A.If):
            walk(s.then)
            walk(s.els)
        elif isinstance(s, A.While):
            walk(s.body)
        elif isinstance(s, A.BFS):
            walk(s.body_fw)
            walk(s.body_bw)

    walk(stmt)
    return out


# --------------------------------------------------------------------------
# The lowerer
# --------------------------------------------------------------------------

class Lowerer:
    def __init__(self, proc: A.Procedure, g: Graph,
                 axis: Optional[str] = None):
        self.proc = proc
        self.g = g
        # Distributed lowering (lang.distribute): edge arrays are local
        # slabs of a mesh axis; every edge-space reduction finishes with a
        # psum/pmin/pmax over ``axis`` (the GPS backend's per-superstep
        # message combine, SURVEY.md §2.6).
        self.axis = axis
        self.graphs: Set[str] = set()
        # collection registry: name -> "NSET"|"NSEQ"|"NORDER"
        self.collections: Dict[str, str] = {}
        # unique per-call-site RNG stream id (see _rng_uniform)
        self._rng_site = 0
        # property registry: name -> ("N"|"E", dtype)
        self.props: Dict[str, Tuple[str, object]] = {}
        self.scalar_dtypes: Dict[str, object] = {}
        for decl in list(proc.args) + list(proc.out_args):
            for name in decl.names:
                t = decl.type
                if t.kind == "GRAPH":
                    self.graphs.add(name)
                elif t.is_property():
                    self.props[name] = (
                        "N" if t.kind == "NODEPROP" else "E",
                        "NSET" if t.elem.kind == "NSET"
                        else dtype_of_kind(t.elem.kind))
                elif t.kind == "NSET":
                    # bitmap over the padded node space (gm_set.h:8);
                    # stored in env as a [N_pad] bool array
                    self.collections[name] = "NSET"
                elif t.kind in ("NSEQ", "NORDER"):
                    # host-eager sequence (gm_seq.h / gm_order.h);
                    # iterated with For(x: S.Items) which the reference
                    # also runs sequentially (gm_cpp_opt_select_par.cc)
                    self.collections[name] = t.kind
                elif t.is_collection() or t.kind == "MAP":
                    raise LowerError(
                        f"collection/map argument {name} not lowerable yet")
                else:
                    self.scalar_dtypes[name] = dtype_of_kind(t.kind)
        # deferred writes: stack of lists keyed by binding iterator
        self._defer_stack: List[Tuple[str, list]] = []
        # active BFS replay: (var, level_array, current_depth)
        self._bfs_ctx: Optional[Tuple[str, jax.Array, int]] = None

    # ---- entry ------------------------------------------------------------
    def run(self, env: Dict) -> Dict:
        self.exec_stmt(self.proc.body, env, None)
        return env

    # ---- cross-shard combine (distributed lowering) ------------------------
    def _pcomb(self, x, sub: str):
        """Combine per-shard partial edge reductions over the mesh axis."""
        if self.axis is None:
            return x
        f = {"add": jax.lax.psum, "min": jax.lax.pmin,
             "max": jax.lax.pmax}.get(sub)
        if f is None:
            raise LowerError(
                f"{sub} reduction not supported in distributed lowering")
        return f(x, self.axis)

    # ---- RNG (gm_rand.h / per-thread erand48 analog) -----------------------
    def _rng_uniform(self, env, ctx, shape=()):
        """Deterministic counter-based uniform draw (threefry).

        The reference seeds one erand48 state per OpenMP thread
        (``gm_runtime.cc:60-75``); the equivalent here is a
        counter-based stream: every call site gets a unique trace-time
        stream id and every dynamic draw bumps a traced counter carried
        through loops, so draws are reproducible and vectorize over any
        context shape.
        """
        import jax.random as jr
        if self.axis is not None:
            raise LowerError("RNG draws not supported in distributed "
                             "lowering yet")
        cnt = env.get(_RNG)
        if cnt is None:
            cnt = jnp.zeros((), jnp.uint32)
        self._rng_site += 1
        key = jr.fold_in(jr.fold_in(jr.PRNGKey(0), cnt), self._rng_site)
        env[_RNG] = (cnt + jnp.uint32(1)).astype(jnp.uint32)
        if ctx is not None:
            shape = ctx.mask.shape
        fd = _float_dtype()
        dt = jnp.float32 if fd == jnp.float32 else fd
        return jr.uniform(key, shape, dtype=dt)

    def _no_random_read(self, what: str):
        """Random-access reads are infeasible under edge sharding — the
        reference's distributed backend rejects them the same way
        (``gm_gps_new_check_random_read.cc``)."""
        if self.axis is not None:
            raise LowerError(
                f"{what} is a random edge-space read; not supported in "
                "distributed lowering (the reference GPS backend rejects "
                "these too)")

    # ---- env write with return-guard --------------------------------------
    def _wr(self, env, key, val):
        done = env.get(_DONE)
        if done is not None and isinstance(done, jax.Array) and key in env:
            old = env[key]
            if isinstance(val, (jax.Array, int, float, bool, np.ndarray)):
                val = jnp.where(done, old, val)
            else:
                # pytree value (collection state): merge leafwise
                val = jax.tree_util.tree_map(
                    lambda o, n: jnp.where(done, o, n), old, val)
        env[key] = val

    # ---- identifier/vector resolution --------------------------------------
    def _ident(self, name: str, env, ctx):
        if ctx is not None:
            if ctx.kind == "node":
                if name == ctx.var or name in ctx.aliases:
                    return ctx.ids
            elif ctx.kind == "wedge":
                if name == ctx.var:
                    return ctx.inner_ids
                if name == ctx.outer_var:
                    return ctx.outer_ids
                v = self._ident(name, env, ctx.parent)
                if isinstance(v, jax.Array) and v.ndim >= 1 and                         v.shape[0] == ctx.parent_len:
                    return v[ctx.sel]
                return v
            else:
                if name == ctx.inner_var:
                    return ctx.inner_ids
                if name == ctx.outer_var:
                    return ctx.outer_ids
                if ctx.parent is not None and (
                        name == ctx.parent.var or name in ctx.parent.aliases):
                    return ctx.outer_ids
        if name not in env:
            raise LowerError(f"unbound symbol {name}")
        v = env[name]
        # parent-node-ctx local vector read from edge ctx: gather at the
        # outer endpoint
        if (ctx is not None and ctx.kind == "edge"
                and isinstance(v, jax.Array)
                and v.ndim == 1 and v.shape[0] == self.g.n_pad):
            return v[ctx.outer_ids]
        return v

    def _prop(self, env, name):
        key = _F + name
        if key not in env:
            raise LowerError(f"unbound property {name}")
        return env[key]

    def _field_read(self, f: A.Field, env, ctx):
        arr = self._prop(env, f.prop)
        loc, _dt = self.props[f.prop]
        ids = self._ident(f.driver, env, ctx)
        if ids is None:
            raise LowerError(f"cannot resolve driver {f.driver}")
        if loc == "E" and ctx is not None and ctx.kind == "edge" and (
                f.driver == ctx.inner_var and not ctx.inner_is_edge):
            raise LowerError(
                f"edge property {f.prop} accessed via node var {f.driver}")
        return arr[ids]

    # ---- expression evaluation ---------------------------------------------
    def eval(self, e: A.Expr, env, ctx):
        if isinstance(e, A.Const):
            if e.ctype == "INF":
                sign = e.value if e.value in (1, -1) else 1
                return jnp.asarray(sign * jnp.inf, _float_dtype())
            if e.ctype == "NIL":
                return jnp.asarray(-1, jnp.int32)
            if e.ctype == "BOOL":
                return jnp.asarray(bool(e.value))
            if e.ctype == "FLOAT":
                return jnp.asarray(float(e.value), _float_dtype())
            return jnp.asarray(int(e.value), jnp.int32)
        if isinstance(e, A.Ident):
            return self._ident(e.name, env, ctx)
        if isinstance(e, A.Field):
            return self._field_read(e, env, ctx)
        if isinstance(e, A.UnOp):
            v = self.eval(e.operand, env, ctx)
            if e.op == "NEG":
                return -v
            if e.op == "NOT":
                return ~v if v.dtype == jnp.bool_ else jnp.logical_not(v)
            if e.op == "ABS":
                return jnp.abs(v)
            raise LowerError(f"unary op {e.op}")
        if isinstance(e, A.Cast):
            v = self.eval(e.operand, env, ctx)
            return _coerce(v, dtype_of_kind(e.to.kind))
        if isinstance(e, A.BinOp):
            return self._binop(e, env, ctx)
        if isinstance(e, A.Ternary):
            c = self.eval(e.cond, env, ctx)
            a = self.eval(e.then, env, ctx)
            b = self.eval(e.els, env, ctx)
            a, b = self._unify(a, b)
            return jnp.where(c, a, b)
        if isinstance(e, A.MapAccess):
            m = env.get(e.map_name)
            if m is None or self.collections.get(e.map_name) != "MAP":
                raise LowerError(f"unbound map {e.map_name}")
            return m.get(jnp.asarray(self.eval(e.key, env, ctx)))
        if isinstance(e, A.Builtin):
            return self._builtin(e, env, ctx)
        if isinstance(e, A.ReduceExpr):
            return self._reduce_expr(e, env, ctx)
        if isinstance(e, A.Foreign):
            # host-native execution: the text is compiled by g++ and
            # called on concrete values (lang/foreign.py); inside a
            # parallel Foreach the compiled wrapper loops the masked
            # lanes — the analog of the reference cpp backend splicing
            # the text into its OpenMP loop body
            # (gm_parse_foreign_syntax.cc:1-261)
            if self.axis is not None:
                raise LowerError(
                    "foreign C++ expression inside a sharded "
                    "context is not lowerable (the reference GPS "
                    "backend rejects foreign text too)")
            from . import foreign as _foreign
            try:
                return _foreign.eval_expr(self, e, env, ctx=ctx)
            except _foreign.ForeignError as fe:
                raise LowerError(str(fe)) from None
        raise LowerError(f"unknown expression {type(e).__name__}")

    @staticmethod
    def _unify(a, b):
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        dt = jnp.promote_types(a.dtype, b.dtype)
        return a.astype(dt), b.astype(dt)

    @staticmethod
    def _inf_vs_int(x, other):
        """Comparing an integer operand against the ±INF literal: the
        reference saturates INF to the integer extrema (``(int)+INF ==
        INT_MAX``, gm_coercion), so an int32 value INT32_MAX *equals*
        +INF.  Promoting to float32 instead would make INT32_MAX != inf
        (f32 can't distinguish them) — the bidir_dijkstra guard bug."""
        x = jnp.asarray(x)
        other = jnp.asarray(other)
        if not (jnp.issubdtype(other.dtype, jnp.integer)
                and jnp.issubdtype(x.dtype, jnp.floating)
                and x.ndim == 0):
            return None
        xv = x if not isinstance(x, jax.core.Tracer) else None
        if xv is None or not np.isinf(np.asarray(jax.device_get(xv))):
            return None
        info = jnp.iinfo(other.dtype)
        return jnp.asarray(
            info.max if float(jax.device_get(xv)) > 0 else info.min,
            other.dtype)

    def _cmp_args(self, a, b):
        sat = self._inf_vs_int(a, b)
        if sat is not None:
            return sat, jnp.asarray(b)
        sat = self._inf_vs_int(b, a)
        if sat is not None:
            return jnp.asarray(a), sat
        return self._unify(a, b)

    def _binop(self, e: A.BinOp, env, ctx):
        a = self.eval(e.lhs, env, ctx)
        b = self.eval(e.rhs, env, ctx)
        op = e.op
        if op == "&&":
            return a & b
        if op == "||":
            return a | b
        if op in ("==", "!="):
            a, b = self._cmp_args(a, b)
            return (a == b) if op == "==" else (a != b)
        if op in ("<", "<=", ">", ">="):
            a, b = self._cmp_args(a, b)
            return {"<": a < b, "<=": a <= b,
                    ">": a > b, ">=": a >= b}[op]
        a, b = self._unify(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if jnp.issubdtype(a.dtype, jnp.integer):
                # C truncating division (generated C++ semantics)
                return jax.lax.div(a, jnp.where(b == 0, 1, b))
            return a / b
        if op == "%":
            return jax.lax.rem(a, jnp.where(b == 0, 1, b))
        raise LowerError(f"binary op {op}")

    # ---- builtins (gm_builtin.cc table -> array ops) ------------------------
    def _builtin(self, e: A.Builtin, env, ctx):
        g = self.g
        name = e.name.lower()
        if e.driver is not None and e.driver in self.graphs:
            # group-assign alias: inside the expansion of
            # ``G.prop = ... G.Degree() ...`` the graph name stands for
            # the per-node iteration variable (gm_expand_group_assignment)
            alias_ids = None
            if ctx is not None and ctx.kind == "node" and \
                    e.driver in ctx.aliases:
                alias_ids = ctx.ids
            if name == "numnodes":
                return jnp.asarray(g.num_nodes, jnp.int32)
            if name == "numedges":
                return jnp.asarray(g.num_edges, jnp.int32)
            if name == "pickrandom":
                # gm_graph::pick_random_node: uniform over node ids
                u = self._rng_uniform(env, ctx)
                v = jnp.floor(u * g.num_nodes).astype(jnp.int32)
                return jnp.clip(v, 0, g.num_nodes - 1)
            if alias_ids is not None:
                ids = alias_ids
                if name in ("degree", "outdegree", "numnbrs"):
                    return g.out_degree()[ids]
                if name in ("indegree", "numinnbrs"):
                    return g.in_degree()[ids]
            raise LowerError(f"graph builtin {e.name}")
        if e.driver is None:
            # driverless math builtins (gm_builtin.cc table: Log, Exp, ...)
            args = [self.eval(a, env, ctx) for a in e.args]
            fd = _float_dtype()
            math1 = {"log": jnp.log, "exp": jnp.exp, "sqrt": jnp.sqrt,
                     "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
                     "floor": jnp.floor, "ceil": jnp.ceil}
            if name in math1 and len(args) == 1:
                return math1[name](jnp.asarray(args[0], fd))
            if name == "abs" and len(args) == 1:
                return jnp.abs(args[0])
            if name == "pow" and len(args) == 2:
                return jnp.power(jnp.asarray(args[0], fd),
                                 jnp.asarray(args[1], fd))
            if name in ("uniform", "rand"):
                # per-context-slot draw (gm_rand.h uniform)
                return self._rng_uniform(env, ctx)
            raise LowerError(f"global builtin {e.name}")
        if e.driver in self.collections:
            coll = env[e.driver]
            kind = self.collections[e.driver]
            if kind == "CTXHIST":
                if ctx is None or ctx.kind != "node":
                    raise LowerError("per-node map read outside its "
                                     "node loop")
                if name == "hasmaxvalue":
                    return coll.has_max_value(
                        self.eval(e.args[0], env, ctx))
                if name == "getmaxkey":
                    return coll.max_key()
                if name == "getmaxvalue":
                    return coll.max_count()
                raise LowerError(
                    f"per-node map builtin {e.name} not lowerable")
            if kind == "MAP":
                if name == "size":
                    return coll.size()
                if name == "haskey":
                    return coll.has_key(self.eval(e.args[0], env, ctx))
                if name == "getminkey":
                    return coll.min_key()
                if name == "getmaxkey":
                    return coll.max_key()
                if name == "getminvalue":
                    return coll.min_value()
                if name == "getmaxvalue":
                    return coll.max_value()
                if name == "hasminvalue":
                    return coll.has_min_value(
                        self.eval(e.args[0], env, ctx))
                if name == "hasmaxvalue":
                    return coll.has_max_value(
                        self.eval(e.args[0], env, ctx))
                raise LowerError(f"map builtin {e.name} not lowerable")
            if kind == "NSET":
                if name == "has":
                    v = self.eval(e.args[0], env, ctx)
                    return coll[v]
                if name == "size":
                    return jnp.sum(coll.astype(jnp.int32))
            else:
                if name == "size":
                    return jnp.asarray(coll.count, jnp.int32)
                if name == "front":
                    return coll.items()[0]
                if name == "back":
                    return coll.items()[coll.count - 1]
                if name == "has" and kind == "NORDER":
                    return coll.has(self.eval(e.args[0], env, ctx))
                if name in ("popback", "popfront") and kind == "NSEQ":
                    # expression-position mutator: a single trace-time
                    # pop would be shared by every slot of a parallel
                    # context, and the driver update must go through the
                    # deferred-write machinery
                    if ctx is not None:
                        raise LowerError(
                            f"{e.name} inside a parallel loop")
                    val, new = (coll.pop_back() if name == "popback"
                                else coll.pop_front())
                    self._wr(env, e.driver, new)
                    return val
            raise LowerError(f"collection builtin {e.name} on "
                             f"{kind} not lowerable yet")
        ids = self._ident(e.driver, env, ctx)
        if name in ("degree", "outdegree", "numnbrs"):
            return g.out_degree()[ids]
        if name in ("indegree", "numinnbrs"):
            return g.in_degree()[ids]
        if name == "pickrandomnbr":
            # uniform over the driver's out-neighbor row; callers guard
            # Degree()==0 themselves (random_walk_sampling...gm)
            self._no_random_read("PickRandomNbr")
            deg = g.out_degree()[ids]
            u = self._rng_uniform(env, ctx,
                                  shape=jnp.shape(jnp.asarray(ids)))
            off = jnp.floor(u * deg).astype(jnp.int32)
            off = jnp.clip(off, 0, jnp.maximum(deg - 1, 0))
            slot = g.begin[ids] + off
            slot = jnp.clip(slot, 0, g.node_idx.shape[0] - 1)
            return g.node_idx[slot]
        if name == "toedge":
            if ctx is None or ctx.kind not in ("edge", "wedge") or \
                    e.driver != getattr(ctx, "inner_var", None) and \
                    e.driver != getattr(ctx, "var", None):
                raise LowerError("ToEdge() outside a neighbor loop")
            return ctx.slots()
        if name in ("fromnode", "from"):
            return g.node_idx_src[ids]
        if name in ("tonode", "to"):
            return g.node_idx[ids]
        if name == "hasedgeto":
            self._no_random_read("HasEdgeTo")
            dst = self.eval(e.args[0], env, ctx)
            src, dst = jnp.broadcast_arrays(jnp.asarray(ids), dst)
            return ops.has_edge_to(g, src, dst)
        if name == "hasedgefrom":
            self._no_random_read("HasEdgeFrom")
            src = self.eval(e.args[0], env, ctx)
            idv, src = jnp.broadcast_arrays(jnp.asarray(ids), src)
            return ops.has_edge_to(g, src, idv)
        if name == "isnbrfrom":
            self._no_random_read("IsNbrFrom")
            src = self.eval(e.args[0], env, ctx)
            idv, src = jnp.broadcast_arrays(jnp.asarray(ids), src)
            return ops.has_edge_to(g, src, idv)
        raise LowerError(f"builtin {e.name} not lowerable yet")

    # ---- neighbor-context construction --------------------------------------
    def _edge_ctx(self, it: A.Iterator, env, ctx) -> EdgeCtx:
        g = self.g
        level_filter = None
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            layout, outer, inner = "csr", g.node_idx_src, g.node_idx
        elif it.iter_type == "IN_NBRS":
            layout, outer, inner = "csc", g.r_node_idx_dst, g.r_node_idx
        elif it.iter_type in ("UP_NBRS", "DOWN_NBRS"):
            # BFS-tree-relative neighbors (gm_cpp_gen_foreach.cc level
            # checks): Up = in-neighbors one level closer to the root,
            # Down = out-neighbors one level deeper.
            if self._bfs_ctx is None or self._bfs_ctx[0] != it.source:
                raise LowerError(f"{it.iter_type} outside its InBFS body")
            _, level, d = self._bfs_ctx
            if it.iter_type == "UP_NBRS":
                layout, outer, inner = ("csc", g.r_node_idx_dst,
                                        g.r_node_idx)
                level_filter = level[inner] == (d - 1)
            else:
                layout, outer, inner = "csr", g.node_idx_src, g.node_idx
                level_filter = level[inner] == (d + 1)
        elif it.iter_type == "EDGES":
            ectx = EdgeCtx(g=g, layout="csr", outer_var="",
                           inner_var=it.var,
                           outer_ids=g.node_idx_src, inner_ids=jnp.arange(
                               g.e_pad, dtype=jnp.int32),
                           mask=g.edge_mask(), parent=None,
                           inner_is_edge=True)
            return ectx
        else:
            raise LowerError(f"iterator {it.iter_type} not lowerable yet")
        mask = g.edge_mask()
        if level_filter is not None:
            mask = mask & level_filter
        src_name = it.source
        if ctx is not None and ctx.kind == "node" and (
                src_name == ctx.var or src_name in ctx.aliases):
            mask = mask & ctx.mask[outer]
            parent = ctx
        elif ctx is None or ctx.kind == "node":
            # neighborhood of a scalar node variable (e.g. root.Nbrs)
            v = self._ident(src_name, env, ctx)
            mask = mask & (outer == v)
            parent = ctx if (ctx is not None and ctx.kind == "node") else None
        else:
            return self._wedge_ctx(it, layout, env, ctx)
        return EdgeCtx(g=g, layout=layout, outer_var=src_name,
                       inner_var=it.var, outer_ids=outer, inner_ids=inner,
                       mask=mask, parent=parent)

    def _wedge_ctx(self, it: A.Iterator, layout: str, env, ctx) -> WedgeCtx:
        """Flatten a nested neighbor iteration to its wedge space."""
        g = self.g
        u = self._ident(it.source, env, ctx)
        if isinstance(u, jax.core.Tracer) or isinstance(ctx.mask,
                                                        jax.core.Tracer):
            raise LowerError(
                "nested neighbor iteration inside a traced loop is not "
                "lowerable (wedge space size depends on data)")
        u_np = np.asarray(u).astype(np.int64)
        m_np = np.asarray(ctx.mask)
        L = int(u_np.shape[0])
        if layout == "csr":
            begin = np.asarray(g.begin).astype(np.int64)
            neigh = g.node_idx
        else:
            begin = np.asarray(g.r_begin).astype(np.int64)
            neigh = g.r_node_idx
        uc = np.clip(u_np, 0, g.num_nodes - 1)
        deg = np.where(m_np & (u_np < g.num_nodes),
                       begin[uc + 1] - begin[uc], 0)
        cum = np.cumsum(deg)
        W = int(cum[-1]) if L else 0
        from ..graph.csr import round_up as _ru
        w_pad = _ru(max(W, 1))
        w_ix = np.arange(w_pad, dtype=np.int64)
        sel = np.searchsorted(cum, np.minimum(w_ix, max(W - 1, 0)),
                              side="right")
        sel = np.minimum(sel, L - 1)
        excl = cum[sel] - deg[sel]
        slot = begin[uc[sel]] + (np.minimum(w_ix, max(W - 1, 0)) - excl)
        slot = np.clip(slot, 0, int(np.asarray(neigh).shape[0]) - 1)
        mask_w = w_ix < W
        offsets = np.concatenate([np.zeros(1, np.int64), cum])
        sel_j = jnp.asarray(sel.astype(np.int32))
        slot_j = jnp.asarray(slot.astype(np.int32))
        return WedgeCtx(
            g=g, var=it.var, outer_var=it.source, layout=layout,
            sel=sel_j, slot=slot_j,
            inner_ids=jnp.asarray(neigh)[slot_j],
            outer_ids=jnp.asarray(uc.astype(np.int32))[sel_j],
            mask=jnp.asarray(mask_w), parent=ctx, parent_len=L,
            parent_offsets=offsets)

    def _node_ctx(self, it: A.Iterator, env, ctx, aliases=()) -> NodeCtx:
        g = self.g
        if ctx is not None:
            raise LowerError("whole-graph loop nested inside a parallel "
                             "context is not lowerable")
        return NodeCtx(g=g, var=it.var,
                       ids=jnp.arange(g.n_pad, dtype=jnp.int32),
                       mask=g.node_mask(), aliases=tuple(aliases))

    # ---- reduce expressions --------------------------------------------------
    def _reduce_expr(self, e: A.ReduceExpr, env, ctx):
        it = e.iterator
        if it.source in self.graphs and it.iter_type == "NODES":
            nctx = self._node_ctx(it, env, None)
            return self._reduce_over_nodes(e, env, nctx)
        if it.iter_type in ("NBRS", "OUT_NBRS", "IN_NBRS", "EDGES",
                            "UP_NBRS", "DOWN_NBRS"):
            ectx = self._edge_ctx(it, env, ctx)
            per_node, scalar = self._reduce_over_edges(e, env, ectx, ctx)
            return per_node if scalar is None else scalar
        if it.iter_type == "COMMON_NBRS":
            ectx = self._common_nbr_ctx(it, env, ctx)
            per_node, scalar = self._reduce_over_edges(e, env, ectx, ctx)
            return per_node if scalar is None else scalar
        raise LowerError(f"reduce over {it.iter_type} not lowerable yet")

    def _common_nbr_ctx(self, it: A.Iterator, env, ctx):
        """``x.CommonNbrs(y)``: iterate x's out-neighbors masked by
        membership in y's row — the sorted-intersection iterator
        (``gm_cpp_opt_common_nbr.cc`` + ``gm_common_neighbor_iter``)
        expressed as a neighbor context plus a binary-search membership
        test over the semi-sorted CSR rows."""
        self._no_random_read("CommonNbrs")
        it2 = dataclasses.replace(it, iter_type="NBRS")
        ectx = self._edge_ctx(it2, env, ctx)
        other = self._ident(it.common_with, env,
                            getattr(ectx, "parent", ctx) or ctx)
        ov = jnp.asarray(other)
        if ov.ndim >= 1 and hasattr(ectx, "sel") and \
                ov.shape[0] == ectx.parent_len:
            ov = ov[ectx.sel]               # wedge space alignment
        ov = jnp.broadcast_to(ov, ectx.mask.shape)
        member = ops.has_edge_to(self.g, ov, ectx.inner_ids)
        return ectx.with_mask(ectx.mask & member)

    def _reduce_over_nodes(self, e: A.ReduceExpr, env, nctx: NodeCtx):
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
        dt = vals.dtype if hasattr(vals, "dtype") else jnp.asarray(vals).dtype
        if e.op == "AVG":
            vals = jnp.asarray(vals, _float_dtype())
            dt = vals.dtype
        ident = _identity(op, dt)
        vals = jnp.where(mask, vals, ident)
        red = {"SUM": jnp.sum, "MULT": jnp.prod, "MIN": jnp.min,
               "MAX": jnp.max, "AND": jnp.all, "OR": jnp.any}[op]
        out = red(vals)
        if e.op == "AVG":
            cnt = jnp.sum(mask.astype(_float_dtype()))
            out = out.astype(_float_dtype()) / jnp.maximum(cnt, 1)
        return out

    def _reduce_over_edges(self, e: A.ReduceExpr, env, ectx: EdgeCtx,
                           outer_ctx):
        """Returns (per_node [N_pad] or None, scalar or None)."""
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
        if ectx.kind == "wedge":
            return self._finish_wedge_reduce(e, vals, mask, ectx), None
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        if op in ("AND", "OR"):
            work = vals.astype(jnp.int8)
            sub = "MIN" if op == "AND" else "MAX"
            ident = _identity(sub, jnp.int8)
            work = jnp.where(mask, work, ident)
            seg = sub
        else:
            ident = _identity(op, vals.dtype)
            work = jnp.where(mask, vals, ident)
            seg = op
            if op == "MULT":
                raise LowerError("Product over neighbors not lowerable yet")
        reduce_to_scalar = (
            outer_ctx is None
            or (ectx.parent is None and not ectx.inner_is_edge)
            or (ectx.inner_is_edge and outer_ctx is None))
        if ectx.inner_is_edge or ectx.parent is None:
            # whole-edge-set or scalar-source neighborhood -> scalar
            _sub = {"SUM": "add", "MIN": "min", "MAX": "max"}
            red = {"SUM": jnp.sum, "MIN": jnp.min, "MAX": jnp.max}[seg] \
                if seg in ("SUM", "MIN", "MAX") else None
            if red is None:
                if op == "OR":
                    out = self._pcomb(jnp.max(work), "max") > 0
                else:
                    out = self._pcomb(jnp.min(work), "min") > 0
            else:
                out = self._pcomb(red(work), _sub[seg])
            if e.op == "AVG":
                cnt = self._pcomb(jnp.sum(mask.astype(_float_dtype())),
                                  "add")
                out = out.astype(_float_dtype()) / jnp.maximum(cnt, 1)
            return None, out
        # per-outer-node segment reduction (sorted by construction)
        sortkey = (ectx.g.node_idx_src if ectx.layout == "csr"
                   else ectx.g.r_node_idx_dst)
        offs = (ectx.g.csr_offsets() if ectx.layout == "csr"
                else ectx.g.csc_offsets())
        segop = {"SUM": "add", "MIN": "min", "MAX": "max"}[seg]
        per_node = self._pcomb(
            ops.sorted_segment_reduce(work, sortkey, offs,
                                      ectx.g.n_pad, segop), segop)
        if op in ("AND", "OR"):
            per_node = (per_node > 0) if op == "OR" else (per_node > 0)
            if seg == "MIN":
                per_node = self._pcomb(ops.sorted_segment_reduce(
                    work, sortkey, offs, ectx.g.n_pad, "min"), "min") > 0
        if e.op == "AVG":
            cnt = self._pcomb(ops.sorted_segment_reduce(
                mask.astype(_float_dtype()), sortkey, offs,
                ectx.g.n_pad, "add"), "add")
            per_node = per_node.astype(_float_dtype()) / jnp.maximum(cnt, 1)
        # align to the outer context's vector of the source variable
        if outer_ctx is not None and outer_ctx.kind == "node":
            if ectx.outer_var == outer_ctx.var or \
                    ectx.outer_var in outer_ctx.aliases:
                return per_node, None
        ids = self._ident(ectx.outer_var, env, outer_ctx)
        return None, per_node[ids]

    def _finish_wedge_reduce(self, e: A.ReduceExpr, vals, mask,
                             wctx: WedgeCtx):
        """Reduce wedge-space values back to the enclosing ctx's space
        (fixed-order segment reduction over the static wedge runs)."""
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        if op in ("AND", "OR"):
            work = vals.astype(jnp.int8)
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", jnp.int8)
        else:
            sub = {"SUM": "add", "MIN": "min", "MAX": "max",
                   "AVG": "add"}.get(op)
            if sub is None:
                raise LowerError(f"{op} over nested neighbors")
            work = vals
            if e.op == "AVG":
                work = work.astype(_float_dtype())
            ident = _identity("SUM" if e.op == "AVG" else op, work.dtype)
        work = jnp.where(mask, work, ident)
        offs = jnp.asarray(wctx.parent_offsets.astype(np.int32))
        ids = wctx.sel
        out = ops.sorted_segment_reduce(work, ids, offs,
                                        wctx.parent_len, sub)
        if op in ("AND", "OR"):
            out = out > 0
        if e.op == "AVG":
            cnt = ops.sorted_segment_reduce(
                mask.astype(_float_dtype()), ids, offs,
                wctx.parent_len, "add")
            out = out / jnp.maximum(cnt, 1)
        return out

    # ---- statements ----------------------------------------------------------
    def exec_stmt(self, s: A.Stmt, env, ctx):
        if isinstance(s, A.Block):
            for st in s.stmts:
                self.exec_stmt(st, env, ctx)
        elif isinstance(s, A.VarDecl):
            self._exec_vardecl(s, env, ctx)
        elif isinstance(s, A.Assign):
            self._exec_assign(s, env, ctx)
        elif isinstance(s, A.ReduceAssign):
            self._exec_reduce_assign(s, env, ctx)
        elif isinstance(s, A.DeferAssign):
            self._exec_defer(s, env, ctx)
        elif isinstance(s, A.ArgMinMaxAssign):
            self._exec_argminmax(s, env, ctx)
        elif isinstance(s, A.Foreach):
            self._exec_foreach(s, env, ctx)
        elif isinstance(s, A.If):
            self._exec_if(s, env, ctx)
        elif isinstance(s, A.While):
            self._exec_while(s, env, ctx)
        elif isinstance(s, A.Return):
            self._exec_return(s, env, ctx)
        elif isinstance(s, A.CallStmt):
            self._exec_call(s.call, env, ctx)
        elif isinstance(s, A.ForeignStmt):
            if self.axis is not None:
                raise LowerError(
                    "foreign C++ statement inside a sharded "
                    "context is not lowerable (the reference GPS "
                    "backend rejects foreign text too)")
            from . import foreign as _foreign
            try:
                _foreign.exec_stmt(self, s, env, ctx=ctx)
            except _foreign.ForeignError as fe:
                raise LowerError(str(fe)) from None
        elif isinstance(s, A.BFS):
            self._exec_bfs(s, env, ctx)
        else:
            raise LowerError(f"statement {type(s).__name__} not lowerable")

    def _exec_call(self, b: A.Builtin, env, ctx):
        """Statement-position builtin call — collection mutators
        (``gm_set.h``/``gm_seq.h`` verbs; select_par runs collection
        iteration sequentially, we vectorize Add under the ctx mask)."""
        name = b.name.lower()
        if b.driver is None and b.driver_field is not None:
            f = b.driver_field
            if f.prop in self.props and self.props[f.prop][1] == "NSET":
                # set-valued node property (N_P<Node_Set>): bit-matrix
                # update v.potFriend.Add(w)
                arr = env[_F + f.prop]
                n_pad = arr.shape[0]
                rows = jnp.asarray(self._ident(f.driver, env, ctx))
                if name in ("add", "remove"):
                    cols = jnp.asarray(self.eval(b.args[0], env, ctx))
                    if ctx is not None:
                        mask = ctx.mask
                        rows = jnp.broadcast_to(rows, mask.shape)
                        cols = jnp.where(mask,
                                         jnp.broadcast_to(cols,
                                                          mask.shape),
                                         n_pad)  # OOB -> dropped
                    new = arr.at[rows, cols].set(name == "add")
                    self._wr(env, _F + f.prop, new)
                    return
                raise LowerError(
                    f"set-property method {b.name} not lowerable yet")
        if b.driver in self.collections:
            kind = self.collections[b.driver]
            cur = env[b.driver]
            if kind == "MAP":
                if name == "remove":
                    if ctx is not None:
                        raise LowerError("map Remove inside a parallel "
                                         "loop not lowerable")
                    k = self.eval(b.args[0], env, ctx)
                    self._wr(env, b.driver, cur.remove(k))
                    return
                if name == "clear":
                    from ..runtime.collections import DenseNodeMap
                    self._wr(env, b.driver, DenseNodeMap.empty(
                        cur.val.shape[0], cur.val.dtype))
                    return
                raise LowerError(
                    f"map method {b.name} not lowerable yet")
            if kind == "NSET":
                if name == "add":
                    v = self.eval(b.args[0], env, ctx)
                    if ctx is None:
                        self._wr(env, b.driver, cur.at[v].set(True))
                    else:
                        upd = jnp.zeros_like(cur).at[v].max(ctx.mask)
                        self._wr(env, b.driver, cur | upd)
                    return
                if name == "remove":
                    v = self.eval(b.args[0], env, ctx)
                    if ctx is None:
                        self._wr(env, b.driver, cur.at[v].set(False))
                    else:
                        upd = jnp.zeros_like(cur).at[v].max(ctx.mask)
                        self._wr(env, b.driver, cur & ~upd)
                    return
                if name == "clear":
                    self._wr(env, b.driver, jnp.zeros_like(cur))
                    return
            else:  # NSEQ / NORDER
                if ctx is not None:
                    raise LowerError(
                        f"{b.name} on a sequence inside a parallel loop "
                        "(order-dependent; the reference serializes "
                        "collection mutation too)")
                v = self.eval(b.args[0], env, ctx) if b.args else None
                if name in ("pushback", "push"):
                    self._wr(env, b.driver, cur.push_back(v))
                    return
                if name == "pushfront":
                    self._wr(env, b.driver, cur.push_front(v))
                    return
            raise LowerError(
                f"collection method {b.name} on {kind} not lowerable yet")
        raise LowerError(f"procedure call {b.name} not lowerable")

    def _exec_vardecl(self, s: A.VarDecl, env, ctx):
        t = s.type
        for name in s.names:
            if t.is_property():
                dt = dtype_of_kind(t.elem.kind)
                loc = "N" if t.kind == "NODEPROP" else "E"
                self.props[name] = (loc, dt)
                arr = (self.g.node_prop(0, dt) if loc == "N"
                       else self.g.edge_prop(0, dt))
                env[_F + name] = arr
            elif t.kind == "NSET":
                self.collections[name] = "NSET"
                env[name] = jnp.zeros((self.g.n_pad,), jnp.bool_)
                if ctx is not None:
                    raise LowerError("set local declared inside a "
                                     "parallel loop not lowerable yet")
            elif t.kind in ("NSEQ", "NORDER"):
                from ..runtime.collections import NodeOrder, NodeSeq
                self.collections[name] = t.kind
                if ctx is not None:
                    raise LowerError("sequence local declared inside a "
                                     "parallel loop not lowerable yet")
                env[name] = (NodeSeq.empty(self.g.n_pad)
                             if t.kind == "NSEQ"
                             else NodeOrder.empty(self.g.n_pad,
                                                  self.g.n_pad))
            elif t.kind == "MAP":
                # Map<Node, V> -> dense value+presence arrays
                # (gm_map.h:12-680; node-keyed, so the hash map becomes
                # a [N_pad] slab — reference small/medium/large split is
                # an XLA non-issue)
                if t.key is None or t.key.kind != "NODE":
                    raise LowerError(
                        f"map local {name}: only Map<Node, V> lowerable")
                if ctx is not None:
                    if ctx.kind != "node":
                        raise LowerError("map local outside a node "
                                         "loop not lowerable")
                    # per-node histogram (communities.gm)
                    self.collections[name] = "CTXHIST"
                    env[name] = _CtxMapHist(self.g.n_pad)
                    ctx.locals.add(name)
                    continue
                from ..runtime.collections import DenseNodeMap
                self.collections[name] = "MAP"
                vdt = (dtype_of_kind(t.value.kind)
                       if t.value is not None else jnp.int32)
                env[name] = DenseNodeMap.empty(self.g.n_pad, vdt)
            elif t.is_collection():
                raise LowerError(f"collection local {name} not "
                                 "lowerable yet")
            else:
                dt = dtype_of_kind(t.kind)
                self.scalar_dtypes[name] = dt
                if s.init is not None:
                    val = _coerce(self.eval(s.init, env, ctx), dt)
                else:
                    val = jnp.zeros((), dt)
                env[name] = val
                if ctx is not None:
                    ctx.locals.add(name)

    def _target_dtype(self, lhs, env):
        if isinstance(lhs, A.Ident):
            return self.scalar_dtypes.get(
                lhs.name, jnp.asarray(env[lhs.name]).dtype
                if lhs.name in env else None)
        if isinstance(lhs, A.Field):
            return self.props[lhs.prop][1]
        return None

    def _exec_ctx_hist_add(self, hist, s, env, ctx, op):
        """Record ``T[k] += w`` increments of a per-node map declared in
        a parallel node loop (communities.gm's label histogram)."""
        if op != "SUM":
            raise LowerError("per-node map supports += only")
        if ctx is None or ctx.kind not in ("edge", "wedge"):
            raise LowerError("per-node map += outside a neighbor loop")
        k = jnp.asarray(self.eval(s.lhs.key, env, ctx))
        v = jnp.asarray(self.eval(s.rhs, env, ctx), jnp.int32)
        mask = ctx.mask
        if ctx.kind == "wedge":
            # owner is the ENCLOSING NODE LOOP's variable, not the
            # wedge's second-hop driver (ctx.outer_ids would attribute
            # the increment to the intermediate neighbor's map)
            par = ctx.parent
            pk = getattr(par, "kind", None)
            if pk == "node":
                owner = jnp.asarray(par.ids)[ctx.sel]
            elif pk == "edge":
                owner = jnp.asarray(par.outer_ids)[ctx.sel]
            else:
                raise LowerError("per-node map += nested too deeply")
        else:
            owner = ctx.outer_ids
        hist.entries.append((
            jnp.broadcast_to(k, mask.shape),
            jnp.broadcast_to(v, mask.shape),
            mask, jnp.broadcast_to(jnp.asarray(owner), mask.shape)))
        hist.cache = None

    def _exec_map_assign(self, s, env, ctx, op=None):
        """``M[k] = v`` / ``M[k] += v`` on a dense node-keyed map."""
        lhs = s.lhs
        m = env.get(lhs.map_name)
        if isinstance(m, _CtxMapHist):
            return self._exec_ctx_hist_add(m, s, env, ctx, op)
        if m is None or self.collections.get(lhs.map_name) != "MAP":
            raise LowerError(f"unbound map {lhs.map_name}")
        k = jnp.asarray(self.eval(lhs.key, env, ctx))
        v = _coerce(self.eval(s.rhs, env, ctx), m.val.dtype)
        if ctx is None and k.ndim == 0:
            if op is None:
                self._wr(env, lhs.map_name, m.set(k, v))
            elif op == "SUM":
                self._wr(env, lhs.map_name, m.add(k, v))
            else:
                raise LowerError(f"map {op}= not lowerable yet")
            return
        # vector keys under a parallel context
        mask = ctx.mask if ctx is not None else jnp.ones(k.shape, bool)
        kv = jnp.broadcast_to(k, mask.shape)
        vv = jnp.broadcast_to(jnp.asarray(v), mask.shape)
        n_pad = m.val.shape[0]
        drop_ids = jnp.where(mask, kv, n_pad)   # OOB scatters drop
        if op is None:
            # duplicate keys: deterministic lowest-slot winner (same
            # policy as racy property writes; reference is last-wins)
            val = self._det_scatter_set(m.val, kv, vv, mask)
        elif op == "SUM":
            sums = jax.ops.segment_sum(
                jnp.where(mask, vv, 0), jnp.minimum(drop_ids, n_pad),
                num_segments=n_pad + 1)[:n_pad]
            base = jnp.where(m.present, m.val, 0)
            val = base + sums
        else:
            raise LowerError(f"map {op}= not lowerable yet")
        pres = m.present.at[drop_ids].set(True)
        from ..runtime.collections import DenseNodeMap
        self._wr(env, lhs.map_name, DenseNodeMap(val, pres))

    def _exec_assign(self, s: A.Assign, env, ctx):
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            return self._exec_map_assign(s, env, ctx)
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if dt is not None:
                val = _coerce(val, dt)
            if ctx is not None and lhs.name not in ctx.locals and \
                    lhs.name in env and not (
                        isinstance(env[lhs.name], jax.Array)
                        and env[lhs.name].ndim >= 1):
                # Scalar WW race: the reference's check2 reports a
                # warning and proceeds with last-store-wins
                # (gm_rw_analysis_check2.cc is_warning=true for
                # WW_CONFLICT).  Deterministic valid instance here:
                # lowest-active-slot winner ("finished = False;" in
                # communities.gm is the uniform special case).
                vv = jnp.asarray(val)
                cur = _coerce(jnp.asarray(env[lhs.name]), vv.dtype)
                if vv.ndim == 0:
                    win = vv
                else:
                    win = vv[jnp.argmax(ctx.mask)]
                self._wr(env, lhs.name,
                         jnp.where(jnp.any(ctx.mask), win, cur))
                return
            self._wr(env, lhs.name, val)
            return
        if isinstance(lhs, A.Field):
            self._exec_field_assign(lhs, s.rhs, env, ctx)
            return
        raise LowerError(f"assignment to {type(lhs).__name__} not lowerable")

    def _exec_field_assign(self, lhs: A.Field, rhs, env, ctx):
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        if lhs.driver in self.graphs:
            # group assignment G.prop = expr  (gm_expand_group_assignment)
            if loc == "N":
                nctx = NodeCtx(g=self.g, var="",
                               ids=jnp.arange(self.g.n_pad,
                                              dtype=jnp.int32),
                               mask=self.g.node_mask(),
                               aliases=(lhs.driver,))
                val = _coerce(self.eval(rhs, env, nctx), dt)
                val = jnp.broadcast_to(val, arr.shape)
                self._wr(env, key, jnp.where(nctx.mask, val, arr))
            else:
                mask = self.g.edge_mask()
                ectx = EdgeCtx(g=self.g, layout="csr", outer_var="",
                               inner_var="", outer_ids=self.g.node_idx_src,
                               inner_ids=jnp.arange(self.g.e_pad,
                                                    dtype=jnp.int32),
                               mask=mask, parent=None, inner_is_edge=True)
                val = _coerce(self.eval(rhs, env, ectx), dt)
                val = jnp.broadcast_to(val, arr.shape)
                self._wr(env, key, jnp.where(mask, val, arr))
            return
        if ctx is not None and ctx.kind == "node" and lhs.driver == ctx.var:
            val = _coerce(self.eval(rhs, env, ctx), dt)
            val = jnp.broadcast_to(val, arr.shape)
            self._wr(env, key, jnp.where(ctx.mask, val, arr))
            return
        if ctx is not None and ctx.kind == "edge":
            # per-slot edge-property write (each slot unique -> race-free);
            # node-prop write keyed by the inner var is a data race.
            if loc == "E" and ctx.inner_is_edge and lhs.driver == \
                    ctx.inner_var:
                val = _coerce(self.eval(rhs, env, ctx), dt)
                val = jnp.broadcast_to(val, arr.shape)
                self._wr(env, key, jnp.where(ctx.mask, val, arr))
                return
            if lhs.driver == ctx.inner_var:
                # intended write-write conflict ("only one will take
                # effect" — random_bipartite_matching.gm): the reference
                # keeps whichever thread's store lands last; we pick a
                # deterministic winner (lowest slot id), which is a valid
                # instance of the same nondeterministic spec
                if loc != "N":
                    raise LowerError("racy edge-prop write keyed by a "
                                     "node variable")
                val = _coerce(self.eval(rhs, env, ctx), dt)
                self._wr(env, key, self._det_scatter_set(
                    arr, ctx.inner_ids, val, ctx.mask))
                return
        # self-update pattern ``x.p = x.p + e`` in a parallel context:
        # the reference emits a racy non-atomic update here (e.g.
        # adamicAdar2's ``from.cnt++``); the deterministic device semantics
        # is the equivalent reduction.
        if ctx is not None and isinstance(rhs, A.BinOp) and \
                rhs.op in ("+", "*") and isinstance(rhs.lhs, A.Field) and \
                rhs.lhs.prop == lhs.prop and rhs.lhs.driver == lhs.driver:
            red = A.ReduceAssign(lhs=lhs, op="SUM" if rhs.op == "+"
                                 else "MULT", rhs=rhs.rhs, bind=None)
            self._exec_reduce_assign(red, env, ctx)
            return
        # scalar node/edge driver (e.g. root.dist = 0)
        ids = self._ident(lhs.driver, env, ctx)
        val = _coerce(self.eval(rhs, env, ctx), dt)
        if ctx is None:
            self._wr(env, key, arr.at[ids].set(val))
            return
        idv = jnp.asarray(ids)
        if idv.ndim == 1 and idv.shape == ctx.mask.shape:
            # write keyed by a per-slot local node vector (e.g.
            # ``Node t = n.Suitor; t.Match = n``) — deterministic
            # lowest-position-winner scatter (see above)
            self._wr(env, key, self._det_scatter_set(
                arr, idv, val, ctx.mask))
            return
        raise LowerError(
            f"assignment to {lhs.driver}.{lhs.prop} in a "
            f"{ctx.kind} context not lowerable")

    def _det_scatter_set(self, arr, ids_vec, val, mask):
        """Masked scatter-set with duplicate keys resolved to the lowest
        context position (reproducible stand-in for the reference's
        last-CAS-wins nondeterminism).  Rejected under edge sharding,
        like the reference's distributed backend rejects random writes
        (gm_gps_new_check_random_write.cc)."""
        if self.axis is not None:
            raise LowerError("random scatter write not supported in "
                             "distributed lowering (the reference GPS "
                             "backend rejects these too)")
        L = ids_vec.shape[0]
        n_rows = arr.shape[0]
        ids_c = jnp.clip(ids_vec, 0, n_rows - 1)
        pos = jnp.arange(L, dtype=jnp.int32)
        cand = jnp.where(mask & (ids_vec >= 0), pos, L)
        win = ops.segment_min(cand, ids_c, n_rows, sorted_ids=False)
        touched = win < L
        winc = jnp.minimum(win, L - 1)
        vals_b = jnp.broadcast_to(jnp.asarray(val), (L,)) \
            if jnp.asarray(val).ndim <= 1 else jnp.asarray(val)
        picked = vals_b[winc].astype(arr.dtype)
        return jnp.where(touched, picked, arr)

    def _owner_lane_key(self, ctx, owner):
        """Per-current-lane index into ``owner``'s lane space, for
        reductions into an enclosing context's scalar local.  Owner
        lanes: NodeCtx = node ids ([N_pad] iota), EdgeCtx = slots."""
        if getattr(ctx, "parent", None) is owner:
            if ctx.kind == "wedge":
                return ctx.sel, ctx.parent_len
            if ctx.kind == "edge":
                return ctx.outer_ids, owner.mask.shape[0]
        if (ctx.kind == "wedge"
                and getattr(ctx.parent, "kind", None) == "edge"
                and getattr(ctx.parent, "parent", None) is owner):
            # wedge -> edge slot -> node lane
            return (jnp.asarray(ctx.parent.outer_ids)[ctx.sel],
                    owner.mask.shape[0])
        raise LowerError(
            "reduction into a local declared more than two loop "
            "levels up not lowerable")

    def _exec_reduce_assign(self, s: A.ReduceAssign, env, ctx):
        op = s.op
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            return self._exec_map_assign(s, env, ctx, op=op)
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if ctx is None:
                cur = env[lhs.name]
                self._wr(env, lhs.name, _coerce(_combine(op, cur, val), dt))
                return
            mask = ctx.mask
            vals = jnp.broadcast_to(jnp.asarray(val), mask.shape)
            # A scalar LOCAL of an enclosing vectorized context reduced
            # from a deeper loop is a PER-LANE accumulator, not a global
            # one (the reference privatizes it per outer iteration —
            # each `n` has its own `tri` in
            #   Foreach(n){ Int tri=0; Foreach(t: n.Nbrs){ tri += ..}}):
            # segment-reduce keyed by the owner lane instead of jnp.sum
            # over everything.
            owner = None
            c = getattr(ctx, "parent", None)
            while c is not None:
                if lhs.name in c.locals:
                    owner = c
                    break
                c = getattr(c, "parent", None)
            if owner is not None:
                key, nseg = self._owner_lane_key(ctx, owner)
                if op in ("AND", "OR"):
                    work = vals.astype(jnp.int8)
                    sub = "min" if op == "AND" else "max"
                    ident = _identity("MIN" if op == "AND" else "MAX",
                                      jnp.int8)
                else:
                    sub = _SEG_OP.get(op)
                    if sub is None:
                        raise LowerError(
                            f"{op}= into an enclosing-loop local "
                            "not lowerable")
                    work = vals
                    ident = _identity(op, vals.dtype)
                work = jnp.where(mask, work, ident)
                seg = {"add": ops.segment_sum, "min": ops.segment_min,
                       "max": ops.segment_max}[sub](
                    work, jnp.asarray(key), nseg, sorted_ids=False)
                if self.axis is not None and ctx.kind == "edge":
                    # partial per-lane results per edge shard
                    seg = (self._pcomb(seg.astype(jnp.int8), sub) > 0
                           if op in ("AND", "OR")
                           else self._pcomb(seg, sub))
                elif op in ("AND", "OR"):
                    seg = seg > 0
                cur = jnp.broadcast_to(jnp.asarray(env[lhs.name]),
                                       seg.shape)
                self._wr(env, lhs.name,
                         _coerce(_combine(op, cur, seg), dt))
                return
            ident = _identity(op, vals.dtype)
            vals = jnp.where(mask, vals, ident)
            red = {"SUM": jnp.sum, "MULT": jnp.prod, "MIN": jnp.min,
                   "MAX": jnp.max, "AND": jnp.all, "OR": jnp.any}[op]
            r = red(vals)
            if self.axis is not None and ctx.kind == "edge":
                if op in ("AND", "OR"):
                    sub = "min" if op == "AND" else "max"
                    r = self._pcomb(r.astype(jnp.int8), sub) > 0
                else:
                    r = self._pcomb(r, _SEG_OP.get(op, op))
            cur = env[lhs.name]
            self._wr(env, lhs.name, _coerce(_combine(op, cur, r), dt))
            return
        if not isinstance(lhs, A.Field):
            raise LowerError("reduce target must be scalar or field")
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        if ctx is None:
            ids = self._ident(lhs.driver, env, ctx)
            val = self.eval(s.rhs, env, ctx)
            cur = arr[ids]
            self._wr(env, key, arr.at[ids].set(
                _coerce(_combine(op, cur, val), dt)))
            return
        if ctx.kind == "node" and lhs.driver == ctx.var:
            val = self.eval(s.rhs, env, ctx)
            val = jnp.broadcast_to(jnp.asarray(val), arr.shape)
            new = _coerce(_combine(op, arr, val), dt)
            self._wr(env, key, jnp.where(ctx.mask, new, arr))
            return
        if ctx.kind == "node" and loc == "N":
            # reduction keyed by a per-slot local node vector
            # (``m.TokenNxt ++`` with random m in the sampling walks):
            # scatter-free segment reduction over arbitrary ids —
            # the reference emits an atomic add here
            # (gm_cpp_gen.cc:1526-1561)
            idv = jnp.asarray(self._ident(lhs.driver, env, ctx))
            if idv.ndim == 1 and idv.shape == ctx.mask.shape:
                val = self.eval(s.rhs, env, ctx)
                vals = jnp.broadcast_to(jnp.asarray(val), ctx.mask.shape)
                if op in ("AND", "OR"):
                    work = vals.astype(jnp.int8)
                    sub = "min" if op == "AND" else "max"
                    ident = _identity("MIN" if op == "AND" else "MAX",
                                      jnp.int8)
                else:
                    ident = _identity(op, vals.dtype)
                    sub = _SEG_OP.get(op)
                    if sub is None:
                        raise LowerError(
                            f"{op}= with random target not lowerable")
                    work = vals
                work = jnp.where(ctx.mask, work, ident)
                # no cross-shard combine: node-context values are
                # replicated under edge sharding — a psum here would
                # multiply SUM results by the shard count
                seg = {"add": ops.segment_sum, "min": ops.segment_min,
                       "max": ops.segment_max}[sub](
                    work, idv, ctx.g.n_pad, sorted_ids=False)
                if op in ("AND", "OR"):
                    seg = seg > 0
                new = _coerce(_combine(op, arr, seg), dt)
                self._wr(env, key, new)
                return
        if ctx.kind == "wedge":
            val = self.eval(s.rhs, env, ctx)
            vals = jnp.broadcast_to(jnp.asarray(val), ctx.mask.shape)
            if op in ("AND", "OR"):
                work = vals.astype(jnp.int8)
                sub = "min" if op == "AND" else "max"
                ident = _identity("MIN" if op == "AND" else "MAX", jnp.int8)
            else:
                ident = _identity(op, vals.dtype)
                sub = _SEG_OP.get(op)
                if sub is None:
                    raise LowerError(f"{op}= in a wedge context")
                work = vals
            work = jnp.where(ctx.mask, work, ident)
            if loc != "N":
                raise LowerError("edge-property reduce in wedge context")
            if lhs.driver == ctx.var:
                key_ids = ctx.inner_ids
            elif lhs.driver == ctx.outer_var:
                key_ids = ctx.outer_ids
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from wedge ctx")
            seg = {"add": ops.segment_sum, "min": ops.segment_min,
                   "max": ops.segment_max}[sub](
                work, key_ids, ctx.g.n_pad, sorted_ids=False)
            if op in ("AND", "OR"):
                seg = seg > 0
            new = _coerce(_combine(op, arr, seg), dt)
            self._wr(env, key, new)
            return
        if ctx.kind == "edge":
            val = self.eval(s.rhs, env, ctx)
            vals = jnp.broadcast_to(jnp.asarray(val), ctx.mask.shape)
            if op in ("AND", "OR"):
                work = vals.astype(jnp.int8)
                sub = "min" if op == "AND" else "max"
                ident = _identity("MIN" if op == "AND" else "MAX", jnp.int8)
                work = jnp.where(ctx.mask, work, ident)
            else:
                ident = _identity(op, vals.dtype)
                work = jnp.where(ctx.mask, vals, ident)
                sub = _SEG_OP.get(op)
                if sub is None:
                    raise LowerError(f"{op}= over neighbors not lowerable")
            if lhs.driver == ctx.outer_var or (
                    ctx.parent is not None and (
                        lhs.driver == ctx.parent.var
                        or lhs.driver in ctx.parent.aliases)):
                # pull: reduce along the sorted axis
                sortkey = (ctx.g.node_idx_src if ctx.layout == "csr"
                           else ctx.g.r_node_idx_dst)
                offs = (ctx.g.csr_offsets() if ctx.layout == "csr"
                        else ctx.g.csc_offsets())
                seg = ops.sorted_segment_reduce(work, sortkey, offs,
                                                ctx.g.n_pad, sub)
            elif lhs.driver == ctx.inner_var:
                # push: unsorted scatter-reduce keyed by the neighbor
                seg = {"add": ops.segment_sum, "min": ops.segment_min,
                       "max": ops.segment_max}[sub](
                    work, ctx.inner_ids, ctx.g.n_pad, sorted_ids=False)
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from edge ctx")
            seg = self._pcomb(seg, sub)
            if op in ("AND", "OR"):
                seg_b = seg > 0
                new = _combine(op, arr, seg_b)
            else:
                new = _coerce(_combine(op, arr, seg.astype(arr.dtype)), dt)
            # only touch rows that had at least one active slot
            touched = self._pcomb(ops.segment_max(
                ctx.mask.astype(jnp.int8),
                ctx.inner_ids if lhs.driver == ctx.inner_var else (
                    ctx.g.node_idx_src if ctx.layout == "csr"
                    else ctx.g.r_node_idx_dst),
                ctx.g.n_pad, sorted_ids=lhs.driver != ctx.inner_var),
                "max") > 0
            self._wr(env, key, jnp.where(touched, new, arr))
            return
        raise LowerError("unsupported reduce-assign placement")

    def _exec_defer(self, s: A.DeferAssign, env, ctx):
        """x <= v @ it — visible only after the binding loop completes
        (the defer opt's double-buffer, gm_cpp_opt_defer.cc)."""
        if ctx is None:
            self._exec_assign(A.Assign(lhs=s.lhs, rhs=s.rhs), env, ctx)
            return
        if not isinstance(s.lhs, A.Field):
            raise LowerError("deferred write target must be a field")
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        if ctx.kind == "node" and s.lhs.driver == ctx.var:
            val = jnp.broadcast_to(val, env[key].shape)
            pend = (key, ctx.mask, val)
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

    def _exec_argminmax(self, s: A.ArgMinMaxAssign, env, ctx):
        """<a; b...> min= <v; w...> — atomic compare-and-swap group write
        (reference spinlock path gm_cpp_gen.cc:1563-1742), lowered to a
        scatter-free segment-min + win-mask payload select."""
        is_min = s.op == "MIN"
        if ctx is None or ctx.kind == "node" or isinstance(s.lhs, A.Ident):
            # scalar-target argminmax reduces over the whole (possibly
            # edge/wedge) context — v_cover's global best-edge pick
            self._argminmax_scalar_or_node(s, env, ctx, is_min)
            return
        # edge context: push to the inner (neighbor) variable
        if not isinstance(s.lhs, A.Field) or s.lhs.driver != ctx.inner_var:
            raise LowerError("argmin/argmax target must be keyed by the "
                             "neighbor variable in a neighbor loop")
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        old = env[key]
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        vals = jnp.broadcast_to(val, ctx.mask.shape)
        ident = _identity("MIN" if is_min else "MAX", dt)
        work = jnp.where(ctx.mask, vals, ident)
        segf = ops.segment_min if is_min else ops.segment_max
        m = segf(work, ctx.inner_ids, ctx.g.n_pad, sorted_ids=False)
        m = self._pcomb(m, "min" if is_min else "max")
        improved = (m < old) if is_min else (m > old)
        new = jnp.where(improved, m, old)
        self._wr(env, key, new)
        if not s.lhs_extra:
            return
        # payload select: find the winning slot deterministically (lowest
        # global slot id among achievers — the reference's winner is
        # whichever thread's CAS lands; ours is reproducible, and under
        # edge sharding the winner is agreed on via a pmin over global
        # slot ids followed by a one-hot psum of the payload)
        extra_vals = [self.eval(r, env, ctx) for r in s.rhs_extra]
        need_slot = any(jnp.asarray(v).ndim >= 1 for v in extra_vals)
        mine = None
        if need_slot:
            slot_ids = jnp.arange(ctx.g.e_pad, dtype=jnp.int32)
            win = ctx.mask & (work == m[ctx.inner_ids])
            cand = jnp.where(win, slot_ids, jnp.asarray(
                ctx.g.e_pad, jnp.int32))
            win_slot = ops.segment_min(cand, ctx.inner_ids, ctx.g.n_pad,
                                       sorted_ids=False)
            if self.axis is not None:
                has_win = win_slot < ctx.g.e_pad
                e_base = (jnp.asarray(ctx.g.e_base, jnp.int32)
                          if ctx.g.e_base is not None else jnp.int32(0))
                g_slot = jnp.where(has_win, win_slot + e_base,
                                   jnp.iinfo(jnp.int32).max)
                g_best = jax.lax.pmin(g_slot, self.axis)
                mine = has_win & (g_slot == g_best)
            win_slot = jnp.minimum(win_slot, ctx.g.e_pad - 1)
        for lhs_e, rhs_v in zip(s.lhs_extra, extra_vals):
            if not isinstance(lhs_e, A.Field) or \
                    lhs_e.driver != ctx.inner_var:
                raise LowerError("argminmax payload target must be keyed "
                                 "by the same neighbor variable")
            _, edt = self.props[lhs_e.prop]
            ekey = _F + lhs_e.prop
            eold = env[ekey]
            rv = jnp.asarray(rhs_v)
            if rv.ndim >= 1:
                payload = _coerce(rv, edt)[win_slot]
                if mine is not None:
                    # exactly one shard owns the winning global slot;
                    # sum-select it across the axis (dtype-preserving)
                    wide = (payload.astype(_float_dtype())
                            if jnp.issubdtype(jnp.dtype(edt), jnp.floating)
                            else payload.astype(jnp.int32))
                    wide = jnp.where(mine, wide, 0)
                    wide = jax.lax.psum(wide, self.axis)
                    payload = (wide > 0) if jnp.dtype(edt) == jnp.bool_ \
                        else wide.astype(edt)
            else:
                payload = _coerce(rv, edt)
            self._wr(env, ekey, jnp.where(improved, payload, eold))

    def _argminmax_scalar_or_node(self, s, env, ctx, is_min):
        # reduction of <value; payload...> into scalars over a node ctx
        if ctx is None:
            raise LowerError("scalar argminmax outside a loop")
        if not isinstance(s.lhs, A.Ident):
            raise LowerError("scalar argminmax target must be an ident")
        dt = self._target_dtype(s.lhs, env)
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        vals = jnp.broadcast_to(val, ctx.mask.shape)
        ident = _identity("MIN" if is_min else "MAX", dt)
        work = jnp.where(ctx.mask, vals, ident)
        best = jnp.min(work) if is_min else jnp.max(work)
        idx = jnp.argmin(work) if is_min else jnp.argmax(work)
        cur = env[s.lhs.name]
        improved = (best < cur) if is_min else (best > cur)
        self._wr(env, s.lhs.name, jnp.where(improved, best, cur))
        for lhs_e, rhs_e in zip(s.lhs_extra, s.rhs_extra):
            if not isinstance(lhs_e, A.Ident):
                raise LowerError("scalar argminmax payload must be ident")
            pv = self.eval(rhs_e, env, ctx)
            pv = jnp.asarray(pv)
            pick = pv[idx] if pv.ndim >= 1 else pv
            edt = self._target_dtype(lhs_e, env)
            if edt is not None:
                pick = _coerce(pick, edt)
            self._wr(env, lhs_e.name, jnp.where(improved, pick,
                                                env[lhs_e.name]))

    def _exec_foreach(self, s: A.Foreach, env, ctx):
        it = s.iterator
        if it.source in self.graphs and it.iter_type == "NODES" and \
                ctx is None and contains_bfs(s.body):
            # sequential For over nodes whose body contains InBFS/InDFS
            # (kosaraju's restart loop) — the reference serializes these
            # too (select_par marks BFS bodies sequential)
            return self._exec_for_nodes_eager(s, env)
        if it.source in self.graphs and it.iter_type == "NODES":
            nctx = self._node_ctx(it, env, ctx)
            if s.filter is not None:
                nctx = nctx.with_mask(nctx.mask &
                                      self.eval(s.filter, env, nctx))
            self._defer_stack.append((it.var, []))
            try:
                self.exec_stmt(s.body, env, nctx)
            finally:
                _, pend = self._defer_stack.pop()
            for key, mask, val in pend:
                self._wr(env, key, jnp.where(mask, val, env[key]))
            return
        if it.source in self.graphs and it.iter_type == "EDGES":
            ectx = self._edge_ctx(it, env, None)
            if s.filter is not None:
                ectx = ectx.with_mask(ectx.mask &
                                      self.eval(s.filter, env, ectx))
            self._defer_stack.append((it.var, []))
            try:
                self.exec_stmt(s.body, env, ectx)
            finally:
                _, pend = self._defer_stack.pop()
            for key, mask, val in pend:
                self._wr(env, key, jnp.where(mask, val, env[key]))
            return
        if it.iter_type in ("NBRS", "OUT_NBRS", "IN_NBRS"):
            # Snapshot env/collections before attempting the vectorized
            # lowering: a LowerError raised mid-body must not leave
            # partially-committed writes behind before the eager retry
            # (otherwise e.g. a += preceding the failing statement would
            # be applied twice).
            snap = dict(env)
            try:
                ectx = self._edge_ctx(it, env, ctx)
                if s.filter is not None:
                    ectx = ectx.with_mask(ectx.mask &
                                          self.eval(s.filter, env, ectx))
                self.exec_stmt(s.body, env, ectx)
                return
            except LowerError:
                # order-dependent body over a *scalar* node's neighbors
                # (tarjan's LowLink min-fold): run it sequentially, like
                # the reference's inner loops (select_par)
                if ctx is not None:
                    raise
                u = snap.get(it.source)
                if u is None or isinstance(u, jax.core.Tracer):
                    raise
                env.clear()
                env.update(snap)
                return self._exec_for_nbrs_eager(s, env)
        if it.iter_type == "COMMON_NBRS":
            ectx = self._common_nbr_ctx(it, env, ctx)
            if s.filter is not None:
                ectx = ectx.with_mask(ectx.mask &
                                      self.eval(s.filter, env, ectx))
            self.exec_stmt(s.body, env, ectx)
            return
        if it.iter_type == "ITEMS":
            return self._exec_for_items(s, env, ctx)
        raise LowerError(f"foreach over {it.iter_type} not lowerable yet")

    # Eager host loops issue one device round-trip per element; they are
    # the faithful lowering for the reference's sequential constructs
    # (select_par), fine at test scale, unusable beyond it.
    _EAGER_SCALE_LIMIT = 100_000

    def _exec_for_nbrs_eager(self, s: A.Foreach, env):
        it = s.iterator
        g = self.g
        if g.num_nodes > self._EAGER_SCALE_LIMIT:
            raise LowerError(
                "sequential neighbor loop on a graph with "
                f"{g.num_nodes} nodes (host round-trip per element; "
                "rewrite the body in vectorizable form)")
        u = int(np.asarray(jax.device_get(env[it.source])))
        if it.iter_type == "IN_NBRS":
            begin, ni = np.asarray(g.r_begin), np.asarray(g.r_node_idx)
        else:
            begin, ni = np.asarray(g.begin), np.asarray(g.node_idx)
        for w in ni[begin[u]:begin[u + 1]]:
            env[it.var] = jnp.asarray(int(w), jnp.int32)
            if s.filter is not None:
                if not bool(np.asarray(jax.device_get(
                        self.eval(s.filter, env, None)))):
                    continue
            self.exec_stmt(s.body, env, None)
        env.pop(it.var, None)

    def _exec_for_nodes_eager(self, s: A.Foreach, env):
        it = s.iterator
        if self.g.num_nodes > self._EAGER_SCALE_LIMIT:
            raise LowerError(
                "sequential node loop on a graph with "
                f"{self.g.num_nodes} nodes (host round-trip per "
                "element; rewrite in vectorizable form)")
        for v in range(self.g.num_nodes):
            env[it.var] = jnp.asarray(v, jnp.int32)
            if s.filter is not None:
                c = self.eval(s.filter, env, None)
                try:
                    if not bool(np.asarray(jax.device_get(c))):
                        continue
                except jax.errors.TracerBoolConversionError:
                    raise LowerError("traced filter on a sequential "
                                     "node loop")
            self.exec_stmt(s.body, env, None)
        env.pop(it.var, None)

    def _exec_for_items(self, s: A.Foreach, env, ctx):
        """Sequential For over collection items — the reference always
        runs collection iteration sequentially
        (``gm_cpp_opt_select_par.cc:27-108``), so an eager host loop over
        the concrete items is the faithful lowering (bc.gm's seed loop)."""
        it = s.iterator
        if ctx is not None:
            raise LowerError("collection iteration inside a parallel loop")
        coll = env.get(it.source)
        if coll is None:
            raise LowerError(f"unbound collection {it.source}")
        kind = self.collections.get(it.source)
        try:
            if kind == "NSET":
                items = np.nonzero(np.asarray(coll))[0]
            elif kind == "NORDER":
                arr = np.asarray(coll.seq.items())
                items = arr[:int(coll.seq.count)]
            else:
                arr = np.asarray(coll.items())
                items = arr[:int(coll.count)]
        except jax.errors.TracerArrayConversionError:
            raise LowerError("collection iteration inside a traced loop "
                             "(items are data-dependent)")
        for v in items:
            env[it.var] = jnp.asarray(int(v), jnp.int32)
            if s.filter is not None:
                c = self.eval(s.filter, env, None)
                try:
                    if not bool(c):
                        continue
                except jax.errors.TracerBoolConversionError:
                    raise LowerError("traced filter on sequential "
                                     "collection iteration")
            self._defer_stack.append((it.var, []))
            try:
                self.exec_stmt(s.body, env, None)
            finally:
                _, pend = self._defer_stack.pop()
            for key, mask, val in pend:
                self._wr(env, key, jnp.where(mask, val, env[key]))
        env.pop(it.var, None)

    def _exec_if(self, s: A.If, env, ctx):
        cond = self.eval(s.cond, env, ctx)
        if ctx is not None:
            c = jnp.broadcast_to(jnp.asarray(cond), ctx.mask.shape)
            self.exec_stmt(s.then, env, ctx.with_mask(ctx.mask & c))
            if s.els is not None:
                self.exec_stmt(s.els, env, ctx.with_mask(ctx.mask & ~c))
            return
        if not isinstance(cond, jax.core.Tracer):
            # concrete condition (eager execution): take one branch —
            # the faithful sequential semantics, and it keeps loops
            # whose guard is false from running at all (bidir_dijkstra's
            # path walk when no path was found)
            try:
                b = bool(np.asarray(jax.device_get(cond)))
                if b:
                    self.exec_stmt(s.then, env, ctx)
                elif s.els is not None:
                    self.exec_stmt(s.els, env, ctx)
                return
            except (TypeError, ValueError):
                pass  # non-scalar: fall through to both-branch merge
        # traced scalar condition: run both branches, where-merge writes
        env_t = dict(env)
        self.exec_stmt(s.then, env_t, ctx)
        env_e = dict(env)
        if s.els is not None:
            self.exec_stmt(s.els, env_e, ctx)
        keys = set()
        for k in set(env_t) | set(env_e):
            if env_t.get(k) is not env.get(k) or \
                    env_e.get(k) is not env.get(k):
                keys.add(k)
        for k in keys:
            tv = env_t.get(k, env.get(k))
            ev = env_e.get(k, env.get(k))
            if tv is None:
                env[k] = ev
            elif ev is None:
                env[k] = tv
            elif not isinstance(tv, (jax.Array, np.ndarray, int, float,
                                     bool, np.generic)):
                # pytree values (NodeSeq etc.): merge leafwise
                env[k] = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(cond, a, b), tv, ev)
            else:
                tv2, ev2 = self._unify(tv, ev)
                env[k] = jnp.where(cond, tv2, ev2)

    def _uses_map(self, stmt) -> bool:
        maps = {n for n, k in self.collections.items() if k == "MAP"}
        if not maps:
            return False
        found = []

        def scan(n):
            if isinstance(n, A.MapAccess) and n.map_name in maps:
                found.append(n)
            if isinstance(n, A.Builtin) and n.driver in maps:
                found.append(n)
        _walk_ast(stmt, scan)
        return bool(found)

    def _exec_while(self, s: A.While, env, ctx):
        if ctx is not None:
            return self._exec_while_masked(s, env, ctx)
        if contains_bfs(s.body):
            # BFS bodies are host-replayed per level (lower_bfs), so a
            # loop containing one runs as an eager host loop — matching
            # the reference, which marks BFS-containing bodies sequential
            # (gm_cpp_opt_select_par.cc).
            return self._exec_while_eager(s, env)
        if self._uses_map(s.body) or self._uses_map(s.cond):
            # Priority-map loops (Dijkstra class): the canonical
            # pop-min/relax idiom lowers to device Bellman-Ford
            # supersteps (lower_priority — the delta-stepping
            # reformulation, removing the 100k host-eager scale cap).
            from .lower_priority import try_bidir_while, try_priority_while
            if try_priority_while(self, s, env):
                return
            if try_bidir_while(self, s, env):
                return
            # Otherwise: inherently sequential in the reference
            # (gm_mutatable_priority_map is not thread-safe); run
            # host-eager — the traced both-branch If merge would
            # evaluate GetMinKey on empty maps and push garbage through
            # masked-write chains.
            return self._exec_while_eager(s, env)
        return self._exec_while_traced(s, env)

    def _exec_while_traced(self, s: A.While, env):
        """The lax.while_loop lowering proper (callable directly by the
        vertex-sharded subclass, whose BFS replay is fully traced)."""
        wkeys = written_keys(s.body)
        dkeys = declared_keys(s.body)
        if uses_rng(s.body) or uses_rng(s.cond):
            wkeys.add(_RNG)
            env.setdefault(_RNG, jnp.zeros((), jnp.uint32))
        carry_keys = sorted((wkeys - dkeys) - {_RET, _DONE})
        if (_RET in wkeys) or (_DONE in wkeys):
            raise LowerError("Return inside While not lowerable yet")
        for k in carry_keys:
            if k not in env:
                raise LowerError(f"loop writes undeclared symbol {k}")
        if s.do_while:
            self.exec_stmt(s.body, env, None)
        # carried values may be plain arrays or registered pytrees
        # (NodeSeq/NodeOrder); lax.while_loop takes the pytree whole
        init = tuple(jnp.asarray(env[k]) if isinstance(
            env[k], (jax.Array, np.ndarray, int, float, bool))
            else env[k] for k in carry_keys)
        shapes = [(v.shape, v.dtype) if isinstance(v, jax.Array) else None
                  for v in init]
        lw = self

        def overlay(carry):
            e2 = dict(env)
            for k, v in zip(carry_keys, carry):
                e2[k] = v
            return e2

        def cond_fn(carry):
            return jnp.asarray(lw.eval(s.cond, overlay(carry), None),
                               jnp.bool_).reshape(())

        def body_fn(carry):
            e2 = overlay(carry)
            lw.exec_stmt(s.body, e2, None)
            out = []
            for k, sd in zip(carry_keys, shapes):
                if sd is None:
                    out.append(e2[k])
                    continue
                shape, dt = sd
                v = jnp.asarray(e2[k])
                if v.shape != shape:
                    raise LowerError(
                        f"loop-carried {k} changes shape {shape}->{v.shape}")
                out.append(v.astype(dt))
            return tuple(out)

        final = jax.lax.while_loop(cond_fn, body_fn, init)
        for k, v in zip(carry_keys, final):
            env[k] = v

    def _exec_while_masked(self, s: A.While, env, ctx):
        """Per-slot While inside a parallel node loop
        (``While (n.Token > 0)`` in parallel_random_walk_jump_sampling):
        one traced ``lax.while_loop`` whose body runs with the mask
        narrowed to the still-active slots — each slot exits its own
        loop independently, like each OpenMP thread exiting its private
        while in the reference's generated code."""
        if ctx.kind != "node":
            raise LowerError("while-loop inside a non-node parallel "
                             "context not lowerable")
        wkeys = written_keys(s.body)
        dkeys = declared_keys(s.body)
        if uses_rng(s.body) or uses_rng(s.cond):
            wkeys.add(_RNG)
            env.setdefault(_RNG, jnp.zeros((), jnp.uint32))
        carry_keys = sorted((wkeys - dkeys) - {_RET, _DONE})
        if (_RET in wkeys) or (_DONE in wkeys):
            raise LowerError("Return inside a masked While")
        for k in carry_keys:
            if k not in env:
                raise LowerError(f"loop writes undeclared symbol {k}")
        init = tuple(jnp.asarray(env[k]) if isinstance(
            env[k], (jax.Array, np.ndarray, int, float, bool))
            else env[k] for k in carry_keys)
        shapes = [(v.shape, v.dtype) if isinstance(v, jax.Array) else None
                  for v in init]
        lw = self

        def overlay(carry):
            e2 = dict(env)
            for k, v in zip(carry_keys, carry):
                e2[k] = v
            return e2

        def cond_of(e2):
            c = jnp.asarray(lw.eval(s.cond, e2, ctx))
            return jnp.broadcast_to(c, ctx.mask.shape)

        # the active set narrows MONOTONICALLY: once a slot observes a
        # false condition it exits for good, like the reference's
        # per-thread while — even if another slot's writes later flip
        # its condition back to true
        def cond_fn(carry):
            act = carry[0]
            return jnp.any(act)

        def body_fn(carry):
            act = carry[0]
            e2 = overlay(carry[1:])
            lw.exec_stmt(s.body, e2, ctx.with_mask(act))
            out = []
            for k, sd in zip(carry_keys, shapes):
                if sd is None:
                    out.append(e2[k])
                    continue
                shape, dt = sd
                v = jnp.asarray(e2[k])
                if v.shape != shape:
                    raise LowerError(
                        f"loop-carried {k} changes shape "
                        f"{shape}->{v.shape}")
                out.append(v.astype(dt))
            new_act = act & cond_of(overlay(tuple(out)))
            return (new_act,) + tuple(out)

        if s.do_while:
            e2 = overlay(init)
            lw.exec_stmt(s.body, e2, ctx)
            init = tuple(jnp.asarray(e2[k]) if sd is not None else e2[k]
                         for k, sd in zip(carry_keys, shapes))
        act0 = ctx.mask & cond_of(overlay(init))
        final = jax.lax.while_loop(cond_fn, body_fn, (act0,) + init)
        for k, v in zip(carry_keys, final[1:]):
            env[k] = v

    def _exec_while_eager(self, s: A.While, env, max_iters=1_000_000):
        """Host-driven sequential loop for untraceable bodies (InBFS)."""
        def cond():
            c = self.eval(s.cond, env, None)
            try:
                return bool(c)
            except jax.errors.TracerBoolConversionError:
                raise LowerError("BFS-containing loop with a traced "
                                 "condition is not lowerable")
        if s.do_while:
            self.exec_stmt(s.body, env, None)
        it = 0
        while cond():
            self.exec_stmt(s.body, env, None)
            it += 1
            if it > max_iters:
                raise LowerError("runaway sequential loop")

    def _exec_return(self, s: A.Return, env, ctx):
        if ctx is not None:
            raise LowerError("Return inside a parallel loop")
        val = (self.eval(s.value, env, ctx)
               if s.value is not None else jnp.zeros((), jnp.int32))
        if self.proc.return_type is not None:
            val = _coerce(val, dtype_of_kind(self.proc.return_type.kind))
        done = env.get(_DONE)
        if done is None:
            env[_RET] = val
            env[_DONE] = jnp.asarray(True)
        else:
            old = env.get(_RET, val)
            old2, val2 = self._unify(old, val)
            env[_RET] = jnp.where(done, old2, val2)
            env[_DONE] = jnp.asarray(True)

    def _exec_bfs(self, s: A.BFS, env, ctx):
        if self.axis is not None and not s.is_bfs:
            # host DFS needs concrete neighbor walks — not expressible
            # under shard_map tracing
            raise LowerError("InDFS not supported in distributed "
                             "lowering (inherently sequential)")
        from .lower_bfs import exec_bfs
        exec_bfs(self, s, env, ctx)


# --------------------------------------------------------------------------
# Public driver
# --------------------------------------------------------------------------

def _bind_collection(kind: str, val, g: Graph):
    """Bind a Node_Set/Seq/Order argument (by-reference in the reference
    runtime, gm_default_usermain.cc): unsupplied -> empty (output-style)."""
    from ..runtime.collections import NodeOrder, NodeSeq, NodeSet
    if kind == "NSET":
        if val is None:
            return jnp.zeros((g.n_pad,), jnp.bool_)
        if isinstance(val, NodeSet):
            return val.bits
        arr = jnp.asarray(val)
        if arr.dtype == jnp.bool_ and arr.shape == (g.n_pad,):
            return arr
        # list of member ids
        return jnp.zeros((g.n_pad,), jnp.bool_).at[arr].set(True)
    if kind == "NSEQ":
        if val is None:
            return NodeSeq.empty(g.n_pad)
        if isinstance(val, NodeSeq):
            return val
        seq = NodeSeq.empty(g.n_pad)
        for v in np.asarray(val).tolist():
            seq = seq.push_back(int(v))
        return seq
    if val is None:
        return NodeOrder.empty(g.n_pad, g.n_pad)
    if isinstance(val, NodeOrder):
        return val
    order = NodeOrder.empty(g.n_pad, g.n_pad)
    for v in np.asarray(val).tolist():
        order = order.push_back(int(v))
    return order


class CompiledProc:
    """A lowered Green-Marl procedure.

    ``__call__(g, *args, **kwargs)`` binds arguments positionally in
    declaration order (graph first, like generated mains) or by name;
    output properties (the reference's post-``;`` args) are allocated
    automatically unless provided.  Returns a dict of output-property
    arrays plus ``"_return"`` when the procedure returns a value.
    """

    def __init__(self, proc: A.Procedure):
        self.proc = proc

    @property
    def name(self):
        return self.proc.name

    def _bind(self, g: Graph, args, kwargs, axis=None):
        env: Dict = {}
        lw = Lowerer(self.proc, g, axis=axis)
        pos = list(args)
        out_names = []
        for decl in self.proc.args:
            for name in decl.names:
                if decl.type.kind == "GRAPH":
                    env[name] = g
                    continue
                if decl.type.kind in ("NSET", "NSEQ", "NORDER"):
                    env[name] = _bind_collection(
                        decl.type.kind, kwargs.get(name), g)
                    if name not in kwargs:
                        out_names.append(name)
                    continue
                if name in kwargs:
                    val = kwargs[name]
                elif pos:
                    val = pos.pop(0)
                elif decl.type.is_property():
                    # properties are by-reference in the reference runtime;
                    # unsupplied ones are allocated (output-style usage,
                    # e.g. hop_dist's dist) and returned
                    loc, dt = lw.props[name]
                    out_names.append(name)
                    env[_F + name] = _alloc_prop(g, loc, dt)
                    continue
                else:
                    raise TypeError(f"missing argument {name}")
                if decl.type.is_property():
                    loc, dt = lw.props[name]
                    env[_F + name] = _coerce(jnp.asarray(val), dt)
                else:
                    env[name] = _coerce(jnp.asarray(val),
                                        dtype_of_kind(decl.type.kind))
        for decl in self.proc.out_args:
            for name in decl.names:
                out_names.append(name)
                if decl.type.is_property():
                    loc, dt = lw.props[name]
                    if name in kwargs:
                        env[_F + name] = _coerce(jnp.asarray(kwargs[name]),
                                                 dt)
                    else:
                        env[_F + name] = _alloc_prop(g, loc, dt)
                else:
                    env[name] = _coerce(
                        jnp.asarray(kwargs.get(name, 0)),
                        dtype_of_kind(decl.type.kind))
        return lw, env, out_names

    def __call__(self, g: Graph, *args, **kwargs):
        lw, env, out_names = self._bind(g, args, kwargs)
        lw.run(env)
        out = {}
        for name in out_names:
            out[name] = env.get(_F + name, env.get(name))
        if _RET in env:
            out["_return"] = env[_RET]
        return out

    def batch(self, g: Graph, over: Dict[str, "jax.Array"], **fixed):
        """Batched-instance execution of the compiled procedure: advance
        one instance per entry of ``over`` in lockstep under ``vmap``
        (the north-star capability the reference lacks — it runs one
        process per instance, SURVEY.md §2.10).

        ``over`` maps scalar argument names to equal-length arrays; all
        other arguments are shared.  Returns the usual output dict with
        a leading batch axis.  Works for any traced-lowerable program
        (host-eager constructs — DFS, map-driven While loops, collection
        Items loops — cannot batch).

        Example::

            cp = compile_file(".../hop_dist.gm")
            out = cp.batch(g, over={"root": jnp.arange(1024)})
            out["dist"]          # [1024, N_pad]
        """
        names = sorted(over)
        vals = [jnp.asarray(over[n]) for n in names]
        if not vals or any(v.shape[0] != vals[0].shape[0]
                           for v in vals):
            raise ValueError("over= arrays must share a leading dim")

        def one(*args):
            kw = dict(fixed)
            kw.update(dict(zip(names, args)))
            return self(g, **kw)

        return jax.vmap(one)(*vals)

    def jit(self):
        """Whole-procedure jit: one XLA program (graph is a pytree arg)."""
        import functools

        @functools.partial(jax.jit, static_argnames=())
        def run(g, args, kwargs):
            return self(g, *args, **kwargs)

        def call(g, *args, **kwargs):
            return run(g, tuple(args), dict(kwargs))

        return call


def compile_source(text: str, name: Optional[str] = None,
                   filename: str = "<input>",
                   optimize: bool = True) -> CompiledProc:
    """Parse + typecheck + optimize + lower a Green-Marl source string."""
    from .parser import parse
    procs = parse(text, filename)
    return _pick(procs, name, optimize)


def compile_file(path: str, name: Optional[str] = None,
                 optimize: bool = True) -> CompiledProc:
    import os
    from .parser import parse_file
    procs = parse_file(path)
    if name is None:
        # prefer the procedure named like the file (the reference's
        # usermain binds <app>_main.cc to the same-named proc);
        # sssp_path.gm, e.g., also contains a get_path helper
        base = os.path.splitext(os.path.basename(path))[0]
        if any(p.name == base for p in procs):
            name = base
    return _pick(procs, name, optimize)


def _pick(procs: List[A.Procedure], name: Optional[str],
          optimize: bool = True) -> CompiledProc:
    """Full pipeline (reference driver ``gm_main.cc:152-290``):
    typecheck -> backend-independent optimizer (``gm_ind_opt.cc:15-24``)
    -> re-typecheck (optimizer-introduced temporaries get fresh
    annotations) -> lower."""
    typecheck(procs)
    # Race detection (reference ``gm_fe_rw_analysis_check2.cc``): WW
    # conflicts are *warnings* there (is_warning=true) — compilation
    # continues and the OpenMP code keeps whichever store lands last.
    # Our lowering gives those writes deterministic lowest-slot-winner
    # semantics (a valid instance of the racy spec); we surface the same
    # warnings so the user learns about the conflict, exactly like the
    # reference's report.
    from .rw_analysis import analyze as _rw_analyze
    rw = _rw_analyze(procs)
    for w in rw.warnings:
        warnings.warn(w, RaceWarning, stacklevel=3)
    if optimize:
        from . import opt
        procs = [opt.optimize(p, clone=True) for p in procs]
        # re-annotate optimizer-introduced temporaries; semantic
        # conflict checks ran on the source form above (optimizer
        # rewrites like nonconf reduce->write would trip them)
        typecheck(procs, semantic=False)
    if name is None:
        cands = [p for p in procs if not p.is_local]
        proc = cands[-1]
    else:
        proc = next(p for p in procs if p.name == name)
    cp = CompiledProc(proc)
    cp.race_warnings = list(rw.warnings)
    return cp
