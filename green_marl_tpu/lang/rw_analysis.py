"""Read/Write/Reduce-set analysis + parallel-conflict (race) detection.

Reimplements the reference's data-race oracle
(``src/frontend/gm_rw_analysis.cc`` with the design doc
``src/inc/gm_rw_analysis.h:10-120``, and the conflict checker
``gm_rw_analysis_check2.cc`` exercised by ``test/rw_check/``): every
statement gets a read-set, write-set and defer/reduce-set of entries
``(symbol, driver, access_range, always, reduce_op, bound)`` with ranges
LINEAR (all-graph iteration), RANDOM (neighborhood / arbitrary node
variable access), SINGLE (fixed node/edge variable) and LEVEL*
(BFS).  Inside a parallel Foreach the checker reports:

* WW: two writes to the same property/scalar that may touch the same
  location (different drivers, or any RANDOM-range write);
* RW: a read that can observe another iteration's write;
* mixed-op or unbound reductions (``gm_fe_reduce_error_check``).

In the JAX runtime these races are *designed out* (functional updates),
so the analysis is a front-end service: it validates DSL programs and
justifies parallel lowering, exactly like the reference compiler.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Set, Tuple

from . import gm_ast as A

LINEAR, RANDOM, SINGLE, LEVEL, LEVEL_UP, LEVEL_DOWN = range(6)

_RANGE_OF_ITER = {
    "NODES": LINEAR, "EDGES": LINEAR, "ITEMS": LINEAR,
    "NBRS": RANDOM, "IN_NBRS": RANDOM, "COMMON_NBRS": RANDOM,
    "UP_NBRS": LEVEL_UP, "DOWN_NBRS": LEVEL_DOWN,
}


@dataclass(frozen=True)
class Entry:
    sym: str                   # property or scalar name
    driver: Optional[str]      # None for scalars
    range: int                 # LINEAR/RANDOM/SINGLE/LEVEL*
    always: bool
    reduce_op: Optional[str] = None
    bound: Optional[str] = None

    def pretty(self):
        rng = ["LINEAR", "RANDOM", "SINGLE", "LEVEL", "LEVEL_UP",
               "LEVEL_DOWN"][self.range]
        d = f" by {self.driver}" if self.driver else ""
        b = f" @{self.bound}" if self.bound else ""
        op = f" {self.reduce_op}=" if self.reduce_op else ""
        return f"({self.sym}{d}, {rng}, " \
               f"{'always' if self.always else 'cond'}{op}{b})"


@dataclass
class RWSets:
    reads: List[Entry] = dfield(default_factory=list)
    writes: List[Entry] = dfield(default_factory=list)
    reduces: List[Entry] = dfield(default_factory=list)

    def pretty(self) -> str:
        parts = []
        if self.reads:
            parts.append("R: " + " ".join(e.pretty() for e in self.reads))
        if self.writes:
            parts.append("W: " + " ".join(e.pretty()
                                          for e in self.writes))
        if self.reduces:
            parts.append("D: " + " ".join(e.pretty()
                                          for e in self.reduces))
        return "  ".join(parts)

    def merge(self, other: "RWSets", always: bool = True):
        def demote(es):
            return [Entry(e.sym, e.driver, e.range,
                          e.always and always, e.reduce_op, e.bound)
                    for e in es]
        self.reads.extend(demote(other.reads))
        self.writes.extend(demote(other.writes))
        self.reduces.extend(demote(other.reduces))


class RWAnalysis:
    def __init__(self, filename: str = "<input>"):
        self.filename = filename
        self.warnings: List[str] = []
        self.errors: List[str] = []
        self.iters: Dict[str, A.Iterator] = {}
        self.sets: Dict[int, RWSets] = {}   # id(stmt) -> sets
        self.decl_frames: List[Set[str]] = [set()]

    def pretty(self) -> str:
        """-Dw report: per-statement R/W/D sets + conflict findings
        (the reference prints its rw maps the same way)."""
        lines = []
        for sets in self.sets.values():
            p = sets.pretty()
            if p:
                lines.append(p)
        for w in self.warnings:
            lines.append(f"warning: {w}")
        for e in self.errors:
            lines.append(f"error: {e}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def range_of_driver(self, name: Optional[str]) -> Tuple[int,
                                                            Optional[str]]:
        if name is None:
            return SINGLE, None
        it = self.iters.get(name)
        if it is None:
            return RANDOM, name      # plain node variable: arbitrary
        return _RANGE_OF_ITER.get(it.iter_type, RANDOM), name

    def expr_reads(self, e: Optional[A.Expr], out: RWSets):
        if e is None:
            return
        if isinstance(e, A.Field):
            rng, drv = self.range_of_driver(e.driver)
            out.reads.append(Entry(e.prop, drv, rng, True))
        elif isinstance(e, A.Ident):
            out.reads.append(Entry(e.name, None, SINGLE, True))
        elif isinstance(e, A.MapAccess):
            out.reads.append(Entry(e.map_name, None, SINGLE, True))
            self.expr_reads(e.key, out)
        elif isinstance(e, A.UnOp):
            self.expr_reads(e.operand, out)
        elif isinstance(e, A.Cast):
            self.expr_reads(e.operand, out)
        elif isinstance(e, A.BinOp):
            self.expr_reads(e.lhs, out)
            self.expr_reads(e.rhs, out)
        elif isinstance(e, A.Ternary):
            self.expr_reads(e.cond, out)
            cond = RWSets()
            self.expr_reads(e.then, cond)
            self.expr_reads(e.els, cond)
            out.merge(cond, always=False)
        elif isinstance(e, A.Builtin):
            if e.driver is not None:
                pass  # driver itself read as scalar
            for a in e.args:
                self.expr_reads(a, out)
        elif isinstance(e, A.ReduceExpr):
            saved = dict(self.iters)
            self.iters[e.iterator.var] = e.iterator
            inner = RWSets()
            self.expr_reads(e.filter, inner)
            body = RWSets()
            self.expr_reads(e.body, body)
            inner.merge(body, always=e.filter is None)
            # iteration makes per-element SINGLE accesses linear/random
            out.merge(self._lift(inner, e.iterator), always=True)
            self.iters = saved

    def _lift(self, sets: RWSets, it: A.Iterator) -> RWSets:
        """Entries driven by ``it.var`` widen to the iterator's range."""
        rng = _RANGE_OF_ITER.get(it.iter_type, RANDOM)

        def widen(es):
            return [Entry(e.sym, None if e.driver == it.var else e.driver,
                          rng if e.driver == it.var else e.range,
                          e.always, e.reduce_op, e.bound) for e in es]
        return RWSets(reads=widen(sets.reads), writes=widen(sets.writes),
                      reduces=widen(sets.reduces))

    # ------------------------------------------------------------------
    def analyze_stmt(self, s: A.Stmt) -> RWSets:
        out = RWSets()
        if isinstance(s, A.Block):
            for c in s.stmts:
                out.merge(self.analyze_stmt(c))
        elif isinstance(s, A.VarDecl):
            self.decl_frames[-1].update(s.names)
            if s.init is not None:
                self.expr_reads(s.init, out)
                out.writes.append(Entry(s.names[0], None, SINGLE, True))
        elif isinstance(s, A.Assign):
            self.expr_reads(s.rhs, out)
            self._lhs_write(s.lhs, out, reduce_op=None, bound=None)
        elif isinstance(s, A.ReduceAssign):
            self.expr_reads(s.rhs, out)
            self._lhs_write(s.lhs, out, reduce_op=s.op, bound=s.bind)
        elif isinstance(s, A.DeferAssign):
            self.expr_reads(s.rhs, out)
            self._lhs_write(s.lhs, out, reduce_op="DEFER", bound=s.bind)
        elif isinstance(s, A.ArgMinMaxAssign):
            self.expr_reads(s.rhs, out)
            for e in s.rhs_extra:
                self.expr_reads(e, out)
            self._lhs_write(s.lhs, out, reduce_op=s.op, bound=s.bind)
            for e in s.lhs_extra:
                self._lhs_write(e, out, reduce_op=s.op, bound=s.bind,
                                supplement=True)
        elif isinstance(s, A.Foreach):
            saved = dict(self.iters)
            self.iters[s.iterator.var] = s.iterator
            inner = RWSets()
            self.expr_reads(s.filter, inner)
            self.decl_frames.append(set())
            body = self.analyze_stmt(s.body)
            # variables declared inside the body are per-iteration
            # private (the reference hoists/privatizes them)
            body = _strip(body, self.decl_frames.pop())
            if not s.sequential:
                self.check_parallel_conflicts(s, body)
            inner.merge(body, always=s.filter is None)
            out.merge(self._lift(inner, s.iterator))
            self.iters = saved
        elif isinstance(s, A.If):
            self.expr_reads(s.cond, out)
            cond = RWSets()
            cond.merge(self.analyze_stmt(s.then))
            if s.els is not None:
                cond.merge(self.analyze_stmt(s.els))
            out.merge(cond, always=False)
        elif isinstance(s, A.While):
            self.expr_reads(s.cond, out)
            out.merge(self.analyze_stmt(s.body), always=s.do_while)
        elif isinstance(s, A.Return):
            self.expr_reads(s.value, out)
        elif isinstance(s, A.CallStmt):
            self.expr_reads(s.call, out)
            if s.call.driver is not None:
                # mutating collection methods write the collection
                aux = getattr(s.call, "builtin", None)
                if aux is not None and aux.aux.startswith("mutate"):
                    out.writes.append(Entry(s.call.driver, None, SINGLE,
                                            True))
        elif isinstance(s, A.ForeignStmt):
            for m in s.mutated:
                self._lhs_write(m, out, reduce_op=None, bound=None)
        elif isinstance(s, A.BFS):
            saved = dict(self.iters)
            self.iters[s.var] = A.Iterator(var=s.var,
                                           source=s.source_graph,
                                           iter_type="NODES")
            self.decl_frames.append(set())
            body = self.analyze_stmt(s.body_fw)
            if s.body_bw is not None:
                body.merge(self.analyze_stmt(s.body_bw))
            body = _strip(body, self.decl_frames.pop())
            self.check_parallel_conflicts(s, body, level=True)
            out.merge(body)
            self.iters = saved
        self.sets[id(s)] = out
        return out

    def _lhs_write(self, lhs: A.Expr, out: RWSets, reduce_op, bound,
                   supplement: bool = False):
        if isinstance(lhs, A.Field):
            rng, drv = self.range_of_driver(lhs.driver)
            e = Entry(lhs.prop, drv, rng, True, reduce_op, bound)
        elif isinstance(lhs, A.Ident):
            e = Entry(lhs.name, None, SINGLE, True, reduce_op, bound)
        elif isinstance(lhs, A.MapAccess):
            self.expr_reads(lhs.key, out)
            e = Entry(lhs.map_name, None, SINGLE, True, reduce_op, bound)
        else:
            return
        (out.reduces if reduce_op else out.writes).append(e)

    # ------------------------------------------------------------------
    def check_parallel_conflicts(self, loop, body: RWSets,
                                 level: bool = False):
        it_var = loop.iterator.var if isinstance(loop, A.Foreach) \
            else loop.var
        loc = loop.loc

        def may_alias(a: Entry, b: Entry) -> bool:
            if a.sym != b.sym:
                return False
            # same driver => same location per iteration => private
            if a.driver is not None and a.driver == b.driver \
                    and a.driver == it_var and a.range != RANDOM \
                    and b.range != RANDOM:
                return False
            # different BFS levels never conflict
            lv = {LEVEL_UP, LEVEL_DOWN}
            if {a.range, b.range} == lv:
                return False
            return True

        # WW
        for i, w1 in enumerate(body.writes):
            for w2 in body.writes[i + 1:]:
                if may_alias(w1, w2):
                    self.warnings.append(
                        f"{self.filename}:{loc.line}: write-write "
                        f"conflict on '{w1.sym}' inside parallel loop "
                        f"'{it_var}'")
            # a single RANDOM-range plain write conflicts with itself
            # across iterations (e.g. ``s.p = 1`` inside nested
            # neighbor loops, random_bipartite_matching's
            # ``t.Suitor = n``) — reference check2 reports WW_CONFLICT
            # as a warning and keeps last-store-wins semantics
            if w1.reduce_op is None and w1.range == RANDOM \
                    and w1.driver != it_var:
                self.warnings.append(
                    f"{self.filename}:{loc.line}: write-write "
                    f"conflict on '{w1.sym}' inside parallel loop "
                    f"'{it_var}' (random-access write)")
            # scalar plain write in parallel loop: WW conflict, a
            # *warning* like every WW in the reference's check2
            # (lowering picks the lowest-active-slot winner)
            if w1.driver is None and w1.reduce_op is None:
                self.warnings.append(
                    f"{self.filename}:{loc.line}: write-write "
                    f"conflict on scalar '{w1.sym}' inside parallel "
                    f"loop '{it_var}'")
        # RW
        for r in body.reads:
            for w in body.writes:
                if may_alias(r, w) and (r.driver != w.driver
                                        or r.range == RANDOM
                                        or w.range == RANDOM):
                    self.warnings.append(
                        f"{self.filename}:{loc.line}: read-write "
                        f"conflict on '{r.sym}' inside parallel loop "
                        f"'{it_var}'")
                    break
        # mixed reduce ops on the same target
        ops: Dict[Tuple[str, Optional[str]], Set[str]] = {}
        for d in body.reduces:
            ops.setdefault((d.sym, d.driver), set()).add(
                d.reduce_op or "?")
        for (sym, drv), s in ops.items():
            if len(s) > 1 and "DEFER" not in s:
                self.errors.append(
                    f"{self.filename}:{loc.line}: mixed reduction "
                    f"operators {sorted(s)} on '{sym}' inside parallel "
                    f"loop '{it_var}'")


def _strip(sets: RWSets, names: Set[str]) -> RWSets:
    if not names:
        return sets

    def keep(es):
        return [e for e in es if e.sym not in names]
    return RWSets(reads=keep(sets.reads), writes=keep(sets.writes),
                  reduces=keep(sets.reduces))


def analyze(procs: List[A.Procedure],
            filename: str = "<input>") -> RWAnalysis:
    rw = RWAnalysis(filename)
    for p in procs:
        rw.analyze_stmt(p.body)
    return rw
