"""Default usermain: graph-in, run-procedure, results-out driver.

Reimplements the reference generated-main runtime
(``apps/output_cpp/gm_graph/src/gm_default_usermain.cc``,
``inc/gm_default_usermain.h:43-57``): declarative schemas for properties
and scalars, CLI flags, input/output format handling, phase timing, and
the machine-parsable stdout protocol the verification harness consumes
(``scripts/extract_result.py``):

* ``<name>[i] = <value>`` per-element golden lines
* ``number of triangles: <T>`` style scalar results
* ``graph loading time=<ms>`` / ``reverse edge creation time=<ms>`` /
  ``running time=<ms>`` (algorithm only; reference
  ``common_main.h:160-205``)
* ``CRC <array> 0x....`` per-output-array checksum lines (Shoal's CRC
  report analog; see ``utils.crc``)

Flags mirror ``-GMMeasureTime -GMNumThreads -GMInputFormat
-GMOutputFormat -GMDumpGraph`` (``gm_default_usermain.cc:26-48``), with
``-GMNumChips`` as the device-count analog of ``-GMNumThreads``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph import binary_io as bio
from ..graph import edge_list as el
from ..graph.csr import Graph, from_edges
from ..utils.crc import array_checksum_hex, crc16_hex
from .useropt import UserOpt

GM_NODEPROP = "node"
GM_EDGEPROP = "edge"
GM_SCALAR = "scalar"

_TYPE_NAMES = {
    bio.GMTYPE_BOOL: bool, bio.GMTYPE_INT: int, bio.GMTYPE_LONG: int,
    bio.GMTYPE_FLOAT: float, bio.GMTYPE_DOUBLE: float,
    bio.GMTYPE_NODE: int, bio.GMTYPE_EDGE: int,
}


@dataclass
class Schema:
    name: str
    type: int              # VALUE_TYPE
    is_input: bool
    is_output: bool
    kind: str              # node/edge/scalar
    dump_count: int = 0    # per-app print count (0 = use -GMDumpValues)


@dataclass
class RunContext:
    graph: Graph
    csr_perm: np.ndarray
    node_props: Dict[str, np.ndarray]
    edge_props: Dict[str, np.ndarray]   # CSR slot order
    scalars: Dict[str, Any]
    nodekey: Optional[np.ndarray] = None
    options: Optional[Any] = None   # the UserOpt instance (flag access)


class UserMain:
    """Declarative app driver (one per algorithm).

    Usage (mirrors generated mains, e.g. ``pagerank_main.cc``)::

        m = UserMain("pagerank")
        m.declare_scalar("max_iter", bio.GMTYPE_INT, True, False, default=100)
        m.declare_property("pg_rank", bio.GMTYPE_DOUBLE, False, True,
                           GM_NODEPROP)
        m.set_run(run_fn)          # RunContext -> dict of outputs
        m.main(argv)
    """

    def __init__(self, proc_name: str, desc: str = ""):
        self.proc_name = proc_name
        self.schemas: List[Schema] = []
        self.defaults: Dict[str, Any] = {}
        self.run_fn: Optional[Callable[[RunContext], Dict[str, Any]]] = None
        self.post_fn: Optional[Callable] = None
        self.O = UserOpt(proc_name, desc)
        self.O.add_option("GMMeasureTime", bool, "0", "Measure running time")
        self.O.add_option("GMProfile", bool, "0",
                          "Per-superstep device timing + per-array "
                          "placement report (Shoal step timers analog)")
        self.O.add_option("GMInputFormat", str, "BIN",
                          "ADJ|EDGE|BIN|EBIN|AVRO")
        self.O.add_option("GMOutputFormat", str, "NULL",
                          "BIN|EBIN|EDGE|NODE_PROP|AVRO|NULL")
        self.O.add_option("GMNumChips", int, None,
                          "Number of devices (mesh size)")
        self.O.add_option("GMPlacement", str, "distribute",
                          "Sharded-run array placement policy: "
                          "'distribute' = vertex-sharded O(N/S) owned "
                          "state + ghost all_to_all; 'replicate' = "
                          "replicated node state + psum combine (the "
                          "Shoal -d vs baseline configs, run.sh:66-105)")
        self.O.add_option("GMPlace", str, None,
                          "Per-array placement override(s), "
                          "'arr:policy[,arr:policy...]' with policy "
                          "replicate|distribute (Shoal "
                          "local_array_settings.lua analog, "
                          "run.sh:218-246)")
        self.O.add_option("GMPlacementFile", str, None,
                          "JSON file {\"arr\": \"policy\", ...} of "
                          "per-array placement overrides "
                          "(generate_settings.py analog)")
        self.O.add_option("GMNumThreads", int, None,
                          "Accepted for reference-CLI compatibility")
        self.O.add_option("GMDumpGraph", int, "0",
                          "1: write output graph/props file")
        self.O.add_option("GMDumpValues", int, "4",
                          "How many leading output values to print")
        self.O.add_argument("InputName", "Input graph filename")
        self.O.add_argument("OutputName", "[optional] Output filename")

    # -- declarations ----------------------------------------------------
    def declare_scalar(self, name, t, is_input, is_output, default=None):
        self.schemas.append(Schema(name, t, is_input, is_output, GM_SCALAR))
        if default is not None:
            self.defaults[name] = default
        if is_input:
            py_t = _TYPE_NAMES[t]
            self.O.add_option(
                name, py_t,
                None if default is None else str(default), "input argument")

    def declare_property(self, name, t, is_input, is_output, kind,
                         dump_count: int = 0):
        self.schemas.append(Schema(name, t, is_input, is_output, kind,
                                   dump_count))

    def set_run(self, fn):
        self.run_fn = fn

    # -- pipeline --------------------------------------------------------
    def load(self) -> RunContext:
        fmt = self.O.get_option("GMInputFormat").upper()
        path = self.O.get_arg(0)
        if path is None:
            self.O.print_help()
            raise SystemExit(1)
        from ..graph import fs
        path = fs.fetch(path)   # hdfs:// and gs:// staged locally
        in_nprops = [s for s in self.schemas
                     if s.kind == GM_NODEPROP and s.is_input]
        in_eprops = [s for s in self.schemas
                     if s.kind == GM_EDGEPROP and s.is_input]
        nodekey = None
        nprop_arrays: List[np.ndarray] = []
        eprop_arrays: List[np.ndarray] = []
        if fmt in ("BIN", "EBIN"):
            raw = bio.load_binary(path)
            g, perm = raw.freeze()
            nodekey = raw.nodekey
            nprop_arrays = raw.node_props
            eprop_arrays = [p[perm] for p in raw.edge_props]
        elif fmt == "EDGE":
            res = el.load_edge_list(
                path, [s.type for s in in_nprops],
                [s.type for s in in_eprops])
            g, eprop_arrays = res.freeze()
            perm = None
            nodekey = res.nodekey
            nprop_arrays = res.node_props
        elif fmt == "ADJ":
            src, dst = el.load_adjacency_list(path)
            g, perm = from_edges(src, dst)
        elif fmt == "AVRO":
            # Avro object container (gm_graph_avro_loader.cc analog)
            from ..graph import avro_io
            (src, dst, nprop_arrays, eav, _, _,
             nn) = avro_io.load_avro(path)
            g, perm = from_edges(src.astype(np.int32),
                                 dst.astype(np.int32), nn)
            eprop_arrays = [np.asarray(p)[perm] for p in eav]
        else:
            raise SystemExit(f"unknown input format {fmt}")
        ctx = RunContext(graph=g,
                         csr_perm=perm if perm is not None else
                         np.arange(g.num_edges),
                         node_props={}, edge_props={}, scalars={},
                         nodekey=nodekey, options=self.O)
        for s, arr in zip(in_nprops, nprop_arrays):
            ctx.node_props[s.name] = arr
        for s, arr in zip(in_eprops, eprop_arrays):
            ctx.edge_props[s.name] = arr
        # loaded-schema report (gm_default_usermain.cc do_preprocess
        # prints what it loaded; apps that declare inputs the file
        # does not carry fail fast in their run() binding)
        print("# loaded: N=%d E=%d fmt=%s node_props=[%s] "
              "edge_props=[%s]" % (
                  g.num_nodes, g.num_edges, fmt,
                  ",".join(ctx.node_props), ",".join(ctx.edge_props)),
              file=sys.stderr)
        for s in self.schemas:
            if s.kind == GM_SCALAR and s.is_input:
                v = self.O.get_option(s.name)
                if v is None and s.name in self.defaults:
                    v = self.defaults[s.name]
                ctx.scalars[s.name] = v
        return ctx

    def main(self, argv: Optional[Sequence[str]] = None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if not self.O.parse(argv):
            return 1
        # per-array overrides only act on the sharded distribute path;
        # a single-chip run would silently ignore them
        if (self.O.get_option("GMPlace")
                or self.O.get_option("GMPlacementFile")) and \
                int(self.O.get_option("GMNumChips") or 1) <= 1:
            raise SystemExit(
                "-GMPlace/-GMPlacementFile require -GMNumChips>1 "
                "(they pin arrays of the distributed placement)")
        t0 = time.time()
        ctx = self.load()
        t1 = time.time()
        print(f"graph loading time={1000*(t1-t0):f}")
        # reverse edges are built inside from_edges; report 0 separately
        # to keep the stdout contract line present (common_main.h:181)
        print(f"reverse edge creation time={0.0:f}")

        assert self.run_fn is not None, "set_run() not called"
        measure = self.O.get_option("GMMeasureTime")
        if measure:
            # the reference's `running time=` excludes everything but the
            # algorithm (common_main.h:160-205); here jit compilation
            # would otherwise dominate — warm up once, time the second
            # call (stdout of the warmup suppressed)
            import contextlib
            import io
            with contextlib.redirect_stdout(io.StringIO()):
                self.run_fn(ctx)
        t2 = time.time()
        outputs = self.run_fn(ctx)
        t3 = time.time()
        if measure:
            print(f"running time={1000*(t3-t2):f}")

        self.report(ctx, outputs)
        self.store(ctx, outputs)
        return 0

    # -- output protocol -------------------------------------------------
    def report(self, ctx: RunContext, outputs: Dict[str, Any]) -> None:
        k = self.O.get_option("GMDumpValues")
        for s in self.schemas:
            if not s.is_output and s.name != "return":
                continue
            val = outputs.get(s.name)
            if val is None:
                continue
            if s.kind == GM_SCALAR:
                print(f"{self.proc_name} returns: {_fmt(val, s.type)}"
                      if s.name == "return"
                      else f"{s.name} = {_fmt(val, s.type)}")
            else:
                arr = np.asarray(val)
                n = (ctx.graph.num_nodes if s.kind == GM_NODEPROP
                     else ctx.graph.num_edges)
                arr = arr[:n]
                kk = s.dump_count or k
                for i in range(min(kk, n)):
                    print(f"{s.name}[{i}] = {_fmt(arr[i], s.type)}")
                print(f"CRC {s.name} {array_checksum_hex(arr)}")
                # Shoal-compatible CRC-16/CCITT-FALSE line (same algorithm
                # as the stub shl.h used by the parity harness,
                # scripts/parity.py) — bit-exact comparable for integer
                # outputs like hop_dist's dist[].
                from ..utils.crc import crc16_hex
                print(f"CRC16 {s.name} {crc16_hex(arr)}")

    def store(self, ctx: RunContext, outputs: Dict[str, Any]) -> None:
        if not self.O.get_option("GMDumpGraph"):
            return
        out = self.O.get_arg(1)
        if out is None:
            return
        fmt = self.O.get_option("GMOutputFormat").upper()
        from ..graph import fs
        dest = out
        if fs.is_remote(out):
            import hashlib
            import os as _os
            import tempfile as _tf
            h = hashlib.sha1(out.encode()).hexdigest()[:10]
            out = _os.path.join(_tf.gettempdir(),
                                f"gmtpu_out_{h}_" +
                                _os.path.basename(out))
        g = ctx.graph
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        out_nprops = [np.asarray(outputs[s.name])[: g.num_nodes]
                      for s in self.schemas
                      if s.kind == GM_NODEPROP and s.is_output
                      and s.name in outputs]
        out_eprops = [np.asarray(outputs[s.name])[: g.num_edges]
                      for s in self.schemas
                      if s.kind == GM_EDGEPROP and s.is_output
                      and s.name in outputs]
        if fmt in ("BIN", "NULL"):
            bio.store_binary(out, begin, node_idx)
        elif fmt == "EBIN":
            bio.store_binary(out, begin, node_idx, nodekey=ctx.nodekey,
                             node_props=out_nprops, edge_props=out_eprops)
        elif fmt == "EDGE":
            deg = np.diff(begin)
            src = np.repeat(np.arange(g.num_nodes), deg)
            el.store_edge_list(out, src, node_idx, nodekey=ctx.nodekey,
                               node_props=out_nprops,
                               edge_props=out_eprops)
        elif fmt == "NODE_PROP":
            with open(out, "w") as f:
                for i in range(g.num_nodes):
                    row = " ".join(str(p[i]) for p in out_nprops)
                    f.write(f"{i} {row}\n")
        elif fmt == "AVRO":
            from ..graph import avro_io
            avro_io.store_avro(out, begin, node_idx,
                               node_props=out_nprops,
                               edge_props=out_eprops)
        else:
            raise SystemExit(f"unknown output format {fmt}")
        if dest != out:
            fs.publish(out, dest)


def _fmt(v, t) -> str:
    if t in (bio.GMTYPE_FLOAT, bio.GMTYPE_DOUBLE):
        return f"{float(v):0.9f}"   # reference: printf("%0.9lf")
    if t == bio.GMTYPE_BOOL:
        return "true" if v else "false"
    return str(int(v))
