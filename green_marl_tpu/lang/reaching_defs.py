"""Reaching-definitions analysis + dead-store elimination.

The reference carries a shared reaching-defs analysis
(``src/common/gm_reaching_def_analysis.cc``) consulted by its optimizer
passes.  This is this build's equivalent: a per-block forward
analysis over FULL definitions —

* scalar assigns ``x = e``,
* group assigns ``G.prop = e`` (unconditional, whole node/edge set),
* unfiltered ``Foreach(n: G.Nodes) { n.prop = e; ... }`` whose direct
  body assigns every element unconditionally —

with everything else (partial/filtered writes, reads anywhere inside a
statement, reductions) treated as a USE.  The consumer pass
``dead_store_elim`` removes a full definition that is KILLED by a later
full definition of the same symbol before any use: each removal deletes
an O(N)/O(E) device pass, and — unlike the flat read/write sets of
``opt._stmt_rw`` — un-blocks ``hoist_foreach``/``loop_merge`` across
the removed store (two loops writing the same property can never be
reordered by the flat check, but when the intervening store is provably
dead there is nothing left to conflict with).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from . import gm_ast as A


def _direct_stmts(s) -> List[A.Stmt]:
    if isinstance(s, A.Block):
        return list(s.stmts)
    return [s]


def full_def_of(s: A.Stmt, graphs: Set[str]) -> Optional[str]:
    """Symbol fully (re)defined by this statement, or None.

    Keys: scalar name, or ``$prop`` for whole-property definitions."""
    if isinstance(s, A.Assign) and isinstance(s.lhs, A.Ident):
        return s.lhs.name
    if isinstance(s, A.Assign) and isinstance(s.lhs, A.Field) and \
            s.lhs.driver in graphs:
        return "$" + s.lhs.prop
    if isinstance(s, A.Foreach) and not s.sequential and \
            s.filter is None and s.iterator.source in graphs and \
            s.iterator.iter_type in ("NODES", "EDGES"):
        for st in _direct_stmts(s.body):
            if isinstance(st, A.Assign) and isinstance(st.lhs, A.Field) \
                    and st.lhs.driver == s.iterator.var:
                return "$" + st.lhs.prop
    return None


def _uses_of(s: A.Stmt) -> Set[str]:
    """Conservative use set of a statement: every scalar read, every
    property read, and every PARTIAL write (a filtered or element-keyed
    write leaves the prior definition partially live)."""
    from .opt import _idents_read, _walk_expr, _walk_exprs_of, \
        _walk_stmts
    out: Set[str] = set()

    def add_reads(e):
        from .opt import _foreign_expr_reads
        for sub in _walk_expr(e):
            if isinstance(sub, A.Field):
                out.add("$" + sub.prop)
                out.add(sub.driver)
            elif isinstance(sub, A.Ident):
                out.add(sub.name)
        out.update(_idents_read(e))
        out.update(_foreign_expr_reads(e))

    for st in _walk_stmts(s):
        if isinstance(st, A.Assign):
            # a plain assignment's TARGET is a write, not a use — only
            # its rhs (and a map key / the field driver) read anything
            add_reads(st.rhs)
            if isinstance(st.lhs, A.MapAccess):
                add_reads(st.lhs.key)
            elif isinstance(st.lhs, A.Field):
                out.add(st.lhs.driver)
            continue
        for e in _walk_exprs_of(st):
            add_reads(e)
        if isinstance(st, A.ForeignStmt):
            from .opt import _foreign_rw
            fr, fw = set(), set()
            _foreign_rw(st, fr, fw)
            out |= fr
            out |= fw   # mutations are partial/effectful: keep prior defs live
    # partial writes (reduce/defer/argminmax targets) leave the prior
    # definition partially live -> count as uses
    for st in _walk_stmts(s):
        if isinstance(st, (A.ReduceAssign, A.DeferAssign)):
            if isinstance(st.lhs, A.Field):
                out.add("$" + st.lhs.prop)
            elif isinstance(st.lhs, A.Ident):
                out.add(st.lhs.name)
        if isinstance(st, A.ArgMinMaxAssign):
            for lhs in [st.lhs] + list(st.lhs_extra):
                if isinstance(lhs, A.Field):
                    out.add("$" + lhs.prop)
                elif isinstance(lhs, A.Ident):
                    out.add(lhs.name)
    return out


class ReachingDefs:
    """Per-block chains: for each full definition, whether a later full
    definition kills it before any use (straight-line within the block;
    nested control flow is opaque and counts as a use of everything it
    touches)."""

    def __init__(self, proc: A.Procedure):
        self.proc = proc
        self.graphs = {n for a in list(proc.args) + list(proc.out_args)
                       for n in a.names if a.type.kind == "GRAPH"}
        # statements (by id) whose full def is provably dead
        self.dead: Set[int] = set()
        self._walk(proc.body)

    def _walk(self, s):
        if isinstance(s, A.Block):
            self._analyze_block(s)
            for st in s.stmts:
                self._walk(st)
        else:
            for attr in ("then", "els", "body", "body_fw", "body_bw"):
                sub = getattr(s, attr, None)
                if sub is not None and isinstance(sub, A.Stmt):
                    self._walk(sub)

    def _analyze_block(self, b: A.Block):
        stmts = b.stmts
        for i, s in enumerate(stmts):
            d = full_def_of(s, self.graphs)
            if d is None:
                continue
            # pure full defs only: the defining statement must not read
            # the symbol itself, or do anything else observable
            if d in _uses_of(s):
                continue
            if isinstance(s, A.Foreach):
                # only single-statement definition loops are removable
                # whole; multi-statement loops do other work
                if len(_direct_stmts(s.body)) != 1:
                    continue
            for t in stmts[i + 1:]:
                if d in _uses_of(t):
                    break
                if full_def_of(t, self.graphs) == d:
                    self.dead.add(id(s))
                    break

    def is_dead_store(self, s: A.Stmt) -> bool:
        return id(s) in self.dead


def dead_store_elim(proc: A.Procedure) -> A.Procedure:
    """Remove full definitions killed before any use (the reaching-defs
    consumer; enables hoist/merge across the removed store)."""
    rd = ReachingDefs(proc)
    if not rd.dead:
        return proc

    def scrub(s):
        if isinstance(s, A.Block):
            s.stmts = [x for x in s.stmts if not rd.is_dead_store(x)]
            for x in s.stmts:
                scrub(x)
        else:
            for attr in ("then", "els", "body", "body_fw", "body_bw"):
                sub = getattr(s, attr, None)
                if sub is not None and isinstance(sub, A.Stmt):
                    scrub(sub)

    scrub(proc.body)
    return proc
