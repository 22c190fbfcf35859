"""Native execution of ``[ C++ ]`` foreign escapes.

The reference cpp backend splices foreign text verbatim into its
generated C++ (``src/parse/gm_parse_foreign_syntax.cc:1-261``,
``test/parse/p10.gm``) with ``$var`` references bound to the enclosing
scope and an optional ``::[x, ...]`` mutation list naming what the text
writes.  The JAX analog keeps the semantics AND the language:
the same text is compiled by g++ into a tiny shared object (the
toolchain the reference's output needs anyway) and executed on the
HOST against the DSL scalar values, with the mutation list written
back.  Scope mirrors the reference's distributed backend limits:

* scalar symbols only (``$x``); ``$n.prop`` field refs are rejected
  (the GPS backend cannot place foreign text either);
* host execution on CONCRETE values — a foreign escape inside traced
  device control flow is rejected with a remedy;
* a text that does not compile (undefined user functions, e.g.
  ``my_function`` in p10.gm) raises with the g++ diagnostic — exactly
  when the reference's generated .cc would fail to build.

Compiled objects are content-hashed and cached per process + on disk.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from typing import Dict, List, Tuple

import numpy as np

_REF = re.compile(r"\$([A-Za-z_][A-Za-z0-9_]*)"
                  r"(\s*\.\s*[A-Za-z_][A-Za-z0-9_]*)?")

_SO_CACHE: Dict[str, ctypes.CDLL] = {}
_DIR = None

_PRELUDE = """#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
"""

_CTYPE = {
    np.dtype(np.int32): ("int32_t", ctypes.c_int32),
    np.dtype(np.int64): ("int64_t", ctypes.c_int64),
    np.dtype(np.float32): ("float", ctypes.c_float),
    np.dtype(np.float64): ("double", ctypes.c_double),
    np.dtype(np.bool_): ("uint8_t", ctypes.c_uint8),
}


class ForeignError(Exception):
    pass


def _refs(text: str) -> List[Tuple[str, bool]]:
    """Ordered unique $refs; (name, is_field)."""
    out, seen = [], set()
    for m in _REF.finditer(text):
        name = m.group(1)
        is_field = m.group(2) is not None
        if (name, is_field) not in seen:
            seen.add((name, is_field))
            out.append((name, is_field))
    return out


def _scalar_np(v):
    """Concrete scalar -> 0-d numpy array; None if not scalar-like."""
    import jax
    if isinstance(v, jax.core.Tracer):
        return None
    if isinstance(v, (bool, int, float, np.generic)):
        return np.asarray(v)
    if isinstance(v, (jax.Array, np.ndarray)):
        a = np.asarray(v)
        return a if a.ndim == 0 else None
    return None


def _compile(src: str, tag: str) -> ctypes.CDLL:
    global _DIR
    h = hashlib.sha256(src.encode()).hexdigest()[:16]
    if h in _SO_CACHE:
        return _SO_CACHE[h]
    if _DIR is None:
        _DIR = tempfile.mkdtemp(prefix="gm_foreign_")
    cc = os.path.join(_DIR, f"f_{h}.cc")
    so = os.path.join(_DIR, f"f_{h}.so")
    if not os.path.exists(so):
        with open(cc, "w") as f:
            f.write(src)
        r = subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-o", so, cc],
            capture_output=True, text=True, timeout=60)
        if r.returncode != 0:
            raise ForeignError(
                f"foreign C++ {tag} does not compile (the reference's "
                f"generated .cc would fail the same way):\n"
                + r.stderr.strip()[:800])
    lib = ctypes.CDLL(so)
    _SO_CACHE[h] = lib
    return lib


def _ctx_lanes(ctx):
    """ids lookup for a parallel context (mirrors Lowerer._ident's ctx
    dispatch, lower.py:600-621, for node/edge/wedge contexts)."""
    if ctx is None:
        return None

    def ids_of(name):
        if ctx.kind == "node":
            if name == ctx.var or name in getattr(ctx, "aliases", ()):
                return ctx.ids
        elif ctx.kind == "wedge":
            if name == ctx.var:
                return ctx.inner_ids
            if name == ctx.outer_var:
                return ctx.outer_ids
        else:       # edge
            if name == ctx.inner_var:
                return ctx.inner_ids
            if name == ctx.outer_var:
                return ctx.outer_ids
            p = getattr(ctx, "parent", None)
            if p is not None and name == getattr(p, "var", None):
                return ctx.outer_ids
        return None

    return ids_of


def _concrete(v, what):
    import jax
    if isinstance(v, jax.core.Tracer):
        raise ForeignError(
            f"foreign: {what} is traced (foreign text runs on the "
            "host; move it outside jit/while control flow)")
    return np.asarray(v)


def _bind(lw, text: str, env, loc_tag: str, ctx=None,
          mutated_props=()):
    """Resolve $refs against env (+ the enclosing parallel context).

    Returns ``(params, body, lanes, mask, decls)``:

    * ``params``: ordered list of dicts — ``kind`` in {"scalar",
      "lane", "prop"}, with the C decl, ctypes type, the bound numpy
      value, and (for props) the env key;
    * ``body``: the text with $refs substituted to C lvalues;
    * ``lanes``/``mask``: per-lane loop extent + validity (None when
      sequential).

    The reference cpp backend splices the same text into the enclosing
    (possibly OpenMP-parallel) loop body with $refs bound to scope
    symbols and ``$n.prop`` to property accesses
    (``gm_parse_foreign_syntax.cc:1-261``); here the loop is a
    compiled host loop over the vectorized lanes, executed in lane
    order (a deterministic schedule of the reference's racy OpenMP
    interleavings — same policy as the lowerer's reductions).
    """
    from .lower import _F
    ids_of = _ctx_lanes(ctx)
    params = []
    by_key = {}
    subs = {}

    def add(key, kind, name, arr, mutable, ckey=None):
        if key in by_key:
            p = by_key[key]
            p["mutable"] = p["mutable"] or mutable
            return p
        if arr.dtype not in _CTYPE:
            raise ForeignError(
                f"foreign {loc_tag}: {name} has unsupported dtype "
                f"{arr.dtype}")
        cty, pyty = _CTYPE[arr.dtype]
        p = dict(key=key, kind=kind, name=name, cty=cty, pyty=pyty,
                 val=arr, mutable=mutable, env_key=ckey)
        by_key[key] = p
        params.append(p)
        return p

    lanes = mask = None
    if ctx is not None:
        mask = _concrete(ctx.mask, "the loop mask")
        lanes = int(mask.shape[0])

    def bind_plain(name):
        if ids_of is not None:
            ids = ids_of(name)
            if ids is not None:
                add(f"v:{name}", "lane", name,
                    _concrete(ids, f"${name}").astype(np.int32), False)
                return f"v_{name}[gm_i]"
        if name not in env:
            raise ForeignError(f"foreign {loc_tag}: unbound symbol "
                               f"${name}")
        v = env[name]
        a = _scalar_np(v)
        if a is not None and a.dtype in _CTYPE:
            add(f"s:{name}", "scalar", name, a, False)
            return f"(*p_{name})"
        if ctx is not None:
            va = _concrete(v, f"${name}")
            if va.ndim == 1 and va.shape[0] == lanes:
                # loop-local scalar: the lowerer keeps it as a masked
                # per-lane vector
                add(f"v:{name}", "lane", name, va, False)
                return f"v_{name}[gm_i]"
        raise ForeignError(
            f"foreign {loc_tag}: ${name} is not a host scalar "
            "(scalar Int/Long/Float/Double/Bool, a loop variable, or "
            "a loop-local)")

    def bind_field(name, prop, mutable):
        key = _F + prop
        if key not in env:
            raise ForeignError(
                f"foreign {loc_tag}: ${name}.{prop}: no property "
                f"'{prop}' in scope")
        arr = _concrete(env[key], f"property {prop}")
        add(f"a:{prop}", "prop", prop, arr, mutable, ckey=key)
        if ids_of is not None and ids_of(name) is not None:
            bind_plain(name)                    # the ids vector
            return f"a_{prop}[v_{name}[gm_i]]"
        # sequential: the driver must be a scalar node/edge id
        sub = bind_plain(name)
        return f"a_{prop}[(int64_t){sub}]"

    body = _REF.sub(
        lambda m: (bind_field(m.group(1),
                              m.group(2).replace(" ", "").lstrip("."),
                              (m.group(1),
                               m.group(2).replace(" ", "").lstrip("."))
                              in mutated_props)
                   if m.group(2) else bind_plain(m.group(1))),
        text)
    # bare identifiers: the reference splices foreign text into a C++
    # scope where DSL symbols are live parameters (test/cpp_be/b9.gm
    # uses [sin(k) / 2] with no $) — alias any in-scope bindable
    # scalar/loop symbol that appears bare with a const local
    decls = []
    seen_bare = set()
    for m in re.finditer(r"[A-Za-z_]\w*", body):
        name = m.group(0)
        if name in seen_bare or f"s:{name}" in by_key or \
                f"v:{name}" in by_key:
            continue
        seen_bare.add(name)
        try:
            sub = bind_plain(name)
        except ForeignError:
            continue        # not a DSL symbol: C library name etc.
        p = by_key.get(f"s:{name}") or by_key[f"v:{name}"]
        decls.append(f"const {p['cty']} {name} = {sub};")
    return params, body, lanes, mask, decls


def _mutated_items(lw, s):
    """Mutation list entries -> ("scalar", name) | ("prop", driver,
    prop)."""
    import green_marl_tpu.lang.gm_ast as A
    out = []
    for m in s.mutated:
        if isinstance(m, A.Field):
            out.append(("prop", m.driver, m.prop))
        elif getattr(m, "name", None) is not None:
            out.append(("scalar", m.name))
        else:
            raise ForeignError(
                "foreign statement: unsupported mutation target "
                f"{type(m).__name__} (scalar or n.prop)")
    return out


def _emit_and_run(params, body, lanes, mask, tag, ret_expr=False,
                  aliases=()):
    """Compile the lane-looped wrapper, run it, return (params,
    out_array_or_None).  Sequential calls run one unmasked lane."""
    decls = []
    for p in params:
        const = "" if p["mutable"] else "const "
        if p["kind"] == "scalar":
            decls.append(f"{p['cty']}* p_{p['name']}")
        elif p["kind"] == "lane":
            decls.append(f"const {p['cty']}* v_{p['name']}")
        else:
            decls.append(f"{const}{p['cty']}* a_{p['name']}")
    if ret_expr:
        decls.append("double* gm_out")
    arglist = ", ".join(["int64_t gm_n", "const uint8_t* gm_mask"]
                        + decls)
    stmt = (f"gm_out[gm_i] = (double)({body});" if ret_expr
            else f"{body};")
    if aliases:
        stmt = "\n    ".join(aliases) + "\n    " + stmt
    src = (_PRELUDE
           + f'extern "C" void gm_foreign({arglist}) {{\n'
           + "  for (int64_t gm_i = 0; gm_i < gm_n; ++gm_i) {\n"
           + "    if (gm_mask && !gm_mask[gm_i]) continue;\n"
           + f"    {stmt}\n"
           + "  }\n}\n")
    lib = _compile(src, tag)
    fn = lib.gm_foreign
    fn.restype = None

    n = 1 if lanes is None else lanes
    margs = None
    if mask is not None:
        margs = np.ascontiguousarray(mask.astype(np.uint8))
    cargs = [ctypes.c_int64(n),
             margs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
             if margs is not None else
             ctypes.POINTER(ctypes.c_uint8)()]
    boxes = {}
    arrs = {}
    for p in params:
        if p["kind"] == "scalar":
            boxes[p["key"]] = p["pyty"](p["val"].item())
            cargs.append(ctypes.byref(boxes[p["key"]]))
        else:
            a = np.ascontiguousarray(p["val"])
            if p["mutable"]:
                a = a.copy()
            arrs[p["key"]] = a
            cargs.append(a.ctypes.data_as(ctypes.POINTER(p["pyty"])))
    out = None
    if ret_expr:
        out = np.zeros(n, np.float64)
        cargs.append(out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
    fn(*cargs)
    return boxes, arrs, out


def exec_stmt(lw, s, env, ctx=None) -> None:
    """Run a ForeignStmt: compile, call (lane-looped when inside a
    parallel Foreach), write back the mutation list (scalars and
    properties)."""
    import jax.numpy as jnp
    text = s.expr.text
    items = _mutated_items(lw, s)
    mut_scalars = [it[1] for it in items if it[0] == "scalar"]
    mut_props = {(it[1], it[2]) for it in items if it[0] == "prop"}
    params, body, lanes, mask, decls = _bind(
        lw, text, env, "statement", ctx=ctx, mutated_props=mut_props)
    by_key = {p["key"]: p for p in params}
    # mutation listed but not referenced in the text: pass it through
    for nm in mut_scalars:
        if f"s:{nm}" in by_key:
            by_key[f"s:{nm}"]["mutable"] = True
        elif f"v:{nm}" in by_key:
            raise ForeignError(
                f"foreign statement: mutating loop-local '{nm}' via "
                "::[] is not supported (assign a property instead)")
        else:
            if nm not in env:
                raise ForeignError(
                    f"foreign statement: unbound mutation target "
                    f"'{nm}'")
            a = _scalar_np(env[nm])
            if a is None or a.dtype not in _CTYPE:
                raise ForeignError(
                    f"foreign statement: mutation target '{nm}' is "
                    "not a host scalar (mutating loop-locals, graphs "
                    "or collections via ::[] is not supported)")
            cty, pyty = _CTYPE[a.dtype]
            p = dict(key=f"s:{nm}", kind="scalar", name=nm, cty=cty,
                     pyty=pyty, val=a, mutable=True, env_key=None)
            params.append(p)
            by_key[p["key"]] = p
    for (drv, prop) in mut_props:
        key = f"a:{prop}"
        if key not in by_key:
            raise ForeignError(
                f"foreign statement: mutation target {drv}.{prop} is "
                "never referenced in the text")
        by_key[key]["mutable"] = True
    boxes, arrs, _ = _emit_and_run(params, body, lanes, mask,
                                   "statement", aliases=decls)
    from .lower import _F
    for nm in mut_scalars:
        p = by_key[f"s:{nm}"]
        lw._wr(env, nm, jnp.asarray(np.asarray(
            boxes[p["key"]].value, p["val"].dtype)))
    for (drv, prop) in mut_props:
        p = by_key[f"a:{prop}"]
        env[p["env_key"]] = jnp.asarray(arrs[p["key"]])


def eval_expr(lw, e, env, ctx=None):
    """Evaluate a foreign expression ([sin($y)/2]); typed DOUBLE like
    the typechecker assumes.  Inside a parallel Foreach the result is
    the per-lane vector (masked-off lanes hold 0.0)."""
    import jax.numpy as jnp
    params, body, lanes, mask, decls = _bind(lw, e.text, env,
                                             "expression", ctx=ctx)
    _, _, out = _emit_and_run(params, body, lanes, mask, "expression",
                              ret_expr=True, aliases=decls)
    from .lower import _float_dtype
    if lanes is None:
        return jnp.asarray(out[0], _float_dtype())
    return jnp.asarray(out.astype(_float_dtype()))
