"""Device-resident CSR graph substrate.

Equivalent of the reference ``gm_graph`` runtime
(``apps/output_cpp/gm_graph/inc/gm_graph.h:119-447``,
``src/gm_graph.cc``): the mutable "flexible" representation lives on the
host (``GraphBuilder``), while the frozen form is an immutable pytree of
padded device arrays (``Graph``).

Reference parity map:

=====================  =========================================================
reference              this module
=====================  =========================================================
``begin[]``            ``Graph.begin`` (edge_t, shape ``[N+1]``)
``node_idx[]``         ``Graph.node_idx`` (node_t, shape ``[E_pad]``, row-sorted)
``make_reverse_edges`` ``Graph.r_begin`` / ``r_node_idx`` / ``e_rev2idx``
                       (``gm_graph.cc:205-296``) — built eagerly by
                       ``from_edges`` because every pull kernel needs them
``prepare_edge_source````Graph.node_idx_src`` (``gm_graph.cc:426-460``)
``do_semi_sort``       rows are always sorted by destination
                       (``gm_graph.cc:468``; enables binary-search
                       ``HasEdgeTo`` and sorted intersection)
``freeze()``           ``GraphBuilder.freeze()`` / ``from_edges``
NODE_SIZE/EDGE_SIZE    ``node_dtype`` / ``edge_dtype`` (``setup.mk.in:55-57``)
=====================  =========================================================

Design notes (not in the reference):

* All O(E) arrays are padded to a multiple of ``LANE`` (128) so every
  E-sized length is a fixed multiple shared by all kernels; padded slots hold the sentinel node id ``N``.  Property arrays are
  allocated with ``N_pad = round_up(N + 1, 128)`` entries so the sentinel is
  a *valid* index into a junk row — out-of-range gathers/scatters land there
  harmlessly instead of relying on clamp semantics.
* ``num_nodes`` / ``num_edges`` are static Python ints (pytree aux data), so
  every kernel sees static shapes and mask iotas fold into the compiled code.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANE = 128  # padding granule: all padded axes are multiples of this.


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """Frozen, device-resident CSR+CSC graph (pytree).

    Leaves are device arrays; ``num_nodes``/``num_edges``/dtype tags are
    static aux data so jitted kernels specialize on them.
    """

    # CSR (push direction): out-edges of node u live in
    # node_idx[begin[u] : begin[u+1]], sorted by destination.
    begin: jax.Array        # [N+1] edge_t
    node_idx: jax.Array     # [E_pad] node_t, dst per CSR slot (pad = N)
    node_idx_src: jax.Array  # [E_pad] node_t, src per CSR slot (pad = N)

    # CSC (pull direction): in-edges of node v live in
    # r_node_idx[r_begin[v] : r_begin[v+1]] (the source endpoints).
    r_begin: jax.Array      # [N+1] edge_t
    r_node_idx: jax.Array   # [E_pad] node_t, src per CSC slot (pad = N)
    r_node_idx_dst: jax.Array  # [E_pad] node_t, dst per CSC slot (pad = N)
    e_rev2idx: jax.Array    # [E_pad] edge_t, CSR slot of each CSC slot

    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))

    # Distributed execution (lang.distribute): when this Graph is a local
    # edge *slab* of a mesh-sharded graph, ``e_base`` is the (traced)
    # global slot index of local slot 0 and the ``*_idx`` arrays hold only
    # this shard's slab, while ``begin``/``r_begin`` stay global.  ``None``
    # for ordinary single-device graphs.  This plays the role of Shoal's
    # per-NUMA-domain array distribution (``run.sh:66-105``) and the GPS
    # backend's vertex partition (SURVEY.md §2.6).
    e_base: Optional[jax.Array] = None

    # ---- static geometry -------------------------------------------------
    @property
    def n_pad(self) -> int:
        """Padded property length: sentinel id ``num_nodes`` is in range."""
        return round_up(self.num_nodes + 1)

    @property
    def e_pad(self) -> int:
        return int(self.node_idx.shape[0])

    @property
    def sentinel(self):
        """Node id used for padded slots (a junk row in property arrays)."""
        return self.num_nodes

    @property
    def node_dtype(self):
        return self.node_idx.dtype

    @property
    def edge_dtype(self):
        return self.begin.dtype

    # ---- masks & degrees (computed, fused into consumers) ----------------
    def edge_mask(self) -> jax.Array:
        """[E_pad] bool — True for real edges (CSR and CSC share E)."""
        slots = jnp.arange(self.e_pad, dtype=jnp.int32)
        if self.e_base is not None:
            slots = slots + jnp.asarray(self.e_base, jnp.int32)
        return slots < self.num_edges

    # ---- slab-local offset views (distributed execution) -----------------
    def csr_offsets(self) -> jax.Array:
        """``begin`` clipped to this shard's slab — segment-reduction
        offsets valid for the local ``node_idx``/``node_idx_src`` arrays.
        Identity for single-device graphs."""
        if self.e_base is None:
            return self.begin
        return jnp.clip(self.begin - jnp.asarray(self.e_base,
                                                 self.begin.dtype),
                        0, self.e_pad)

    def csc_offsets(self) -> jax.Array:
        """``r_begin`` clipped to this shard's slab (see csr_offsets)."""
        if self.e_base is None:
            return self.r_begin
        return jnp.clip(self.r_begin - jnp.asarray(self.e_base,
                                                   self.r_begin.dtype),
                        0, self.e_pad)

    def node_mask(self) -> jax.Array:
        """[N_pad] bool — True for real nodes."""
        return jnp.arange(self.n_pad, dtype=jnp.int32) < self.num_nodes

    def out_degree(self) -> jax.Array:
        """[N_pad] edge_t; reference ``OutDegree()`` builtin."""
        deg = self.begin[1:] - self.begin[:-1]
        return _pad_to(deg, self.n_pad)

    def in_degree(self) -> jax.Array:
        """[N_pad] edge_t; reference ``InDegree()`` builtin."""
        deg = self.r_begin[1:] - self.r_begin[:-1]
        return _pad_to(deg, self.n_pad)

    # ---- property allocation --------------------------------------------
    def node_prop(self, fill, dtype) -> jax.Array:
        """Allocate a node property array (reference ``Node_Prop<T>``)."""
        return jnp.full((self.n_pad,), fill, dtype=dtype)

    def edge_prop(self, fill, dtype) -> jax.Array:
        """Allocate an edge property array in CSR slot order."""
        return jnp.full((self.e_pad,), fill, dtype=dtype)


def _pad_to(x: jax.Array, n: int, fill=0) -> jax.Array:
    return jnp.pad(x, (0, n - x.shape[0]), constant_values=fill)


# ---------------------------------------------------------------------------
# Host-side construction (reference flexible-format + freeze()).
# ---------------------------------------------------------------------------

def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: Optional[int] = None,
    node_dtype=np.int32,
    edge_dtype=np.int32,
) -> Tuple[Graph, np.ndarray]:
    """Build a frozen ``Graph`` from an edge list (host, numpy).

    Equivalent of ``gm_graph::freeze()`` + ``do_semi_sort()`` +
    ``make_reverse_edges()`` + ``prepare_edge_source()`` fused into one
    vectorized pass (``src/gm_graph.cc:68-112,205-296,426-468``).

    Returns ``(graph, csr_perm)`` where ``csr_perm[i]`` is the input-order
    index of the edge occupying CSR slot ``i`` — use it to permute edge
    properties supplied in input order (the reference tracks the same thing
    through ``e_id2idx`` during semi-sort).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be equal-length 1-D arrays")
    E = int(src.shape[0])
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    N = int(num_nodes)
    src = src.astype(node_dtype, copy=False)
    dst = dst.astype(node_dtype, copy=False)
    if E and (src.min() < 0 or dst.min() < 0 or src.max() >= N or dst.max() >= N):
        raise ValueError("edge endpoint out of range")

    e_pad = round_up(max(E, 1))

    native_built = None
    if E and np.dtype(node_dtype) == np.int32 and \
            np.dtype(edge_dtype) == np.int32:
        from . import native as _native
        if _native.available():
            native_built = _native.build_csr(src, dst, N)
    if native_built is not None:
        (begin, csr_dst, csr_src, csr_perm, r_begin, csc_src, csc_dst,
         e_rev2idx) = native_built
    else:
        # CSR: sort by (src, dst) — semi-sorted rows for free.
        csr_perm = np.lexsort((dst, src)).astype(edge_dtype)
        csr_src = src[csr_perm]
        csr_dst = dst[csr_perm]
        begin = np.zeros(N + 1, dtype=edge_dtype)
        np.cumsum(np.bincount(src, minlength=N), out=begin[1:],
                  dtype=edge_dtype)

        # CSC: sort by (dst, src); e_rev2idx maps CSC slot -> CSR slot.
        csc_of_input = np.lexsort((src, dst)).astype(edge_dtype)
        csc_src = src[csc_of_input]
        csc_dst = dst[csc_of_input]
        r_begin = np.zeros(N + 1, dtype=edge_dtype)
        np.cumsum(np.bincount(dst, minlength=N), out=r_begin[1:],
                  dtype=edge_dtype)
        input_to_csr = np.empty(E, dtype=edge_dtype)
        input_to_csr[csr_perm] = np.arange(E, dtype=edge_dtype)
        e_rev2idx = input_to_csr[csc_of_input]

    sent = np.dtype(node_dtype).type(N)

    def padded(a, fill):
        out = np.full(e_pad, fill, dtype=a.dtype)
        out[:E] = a
        return out

    g = Graph(
        begin=jnp.asarray(begin),
        node_idx=jnp.asarray(padded(csr_dst, sent)),
        node_idx_src=jnp.asarray(padded(csr_src, sent)),
        r_begin=jnp.asarray(r_begin),
        r_node_idx=jnp.asarray(padded(csc_src, sent)),
        r_node_idx_dst=jnp.asarray(padded(csc_dst, sent)),
        e_rev2idx=jnp.asarray(padded(e_rev2idx, np.dtype(edge_dtype).type(0))),
        num_nodes=N,
        num_edges=E,
    )
    return g, csr_perm


class GraphBuilder:
    """Mutable host-side graph — the reference's "flexible format"
    (``gm_graph.h:186-203``: ``add_node``/``add_edge`` then ``freeze()``
    into CSR; ``thaw()`` back to flexible for further mutation) plus
    the node-key remapping surface (``gm_graph.h:396-436``:
    ``add_nodekey``/``find_nodekey``/``find_nodeid`` translate external
    node keys to dense internal ids)."""

    def __init__(self, node_dtype=np.int32, edge_dtype=np.int32):
        self._src: list = []
        self._dst: list = []
        self._num_nodes = 0
        self.node_dtype = node_dtype
        self.edge_dtype = edge_dtype
        self._key2id: dict = {}
        self._id2key: list = []

    @classmethod
    def thaw(cls, g: Graph, node_dtype=np.int32,
             edge_dtype=np.int32) -> "GraphBuilder":
        """CSR -> flexible (``gm_graph::thaw``, gm_graph.h:186): a
        mutable builder seeded with the graph's live edges; mutate,
        then ``freeze()`` into a new CSR Graph."""
        b = cls(node_dtype=node_dtype, edge_dtype=edge_dtype)
        begin = np.asarray(g.begin)[: g.num_nodes + 1]
        dst = np.asarray(g.node_idx)[: g.num_edges]
        src = np.repeat(np.arange(g.num_nodes, dtype=node_dtype),
                        np.diff(begin.astype(np.int64)))
        b.add_edges(src, dst.astype(node_dtype, copy=False))
        b._num_nodes = max(b._num_nodes, g.num_nodes)
        return b

    # -- node-key remapping (gm_graph.h:396-436) ----------------------
    def add_nodekey(self, key) -> int:
        """External key -> dense internal id (created on first use)."""
        nid = self._key2id.get(key)
        if nid is None:
            nid = self.add_node()
            self._key2id[key] = nid
            self._id2key.extend([None] * (nid + 1 - len(self._id2key)))
            self._id2key[nid] = key
        return nid

    def find_nodekey(self, key) -> int:
        """Key -> id, -1 when absent (``gm_graph::find_nodekey``)."""
        return self._key2id.get(key, -1)

    def find_nodeid(self, nid: int):
        """Id -> key (``gm_graph::find_nodeid``); None when the node
        was created without a key."""
        return self._id2key[nid] if 0 <= nid < len(self._id2key) \
            else None

    def add_keyed_edge(self, skey, dkey) -> None:
        self.add_edge(self.add_nodekey(skey), self.add_nodekey(dkey))

    @property
    def nodekeys(self) -> list:
        return list(self._id2key)

    def add_node(self) -> int:
        self._num_nodes += 1
        return self._num_nodes - 1

    def add_nodes(self, n: int) -> None:
        self._num_nodes += int(n)

    def add_edge(self, s: int, d: int) -> None:
        self._src.append(s)
        self._dst.append(d)
        self._num_nodes = max(self._num_nodes, s + 1, d + 1)

    def add_edges(self, src, dst) -> None:
        src = np.asarray(src)
        dst = np.asarray(dst)
        self._src.append(src)
        self._dst.append(dst)
        if src.size:
            self._num_nodes = max(
                self._num_nodes, int(src.max()) + 1, int(dst.max()) + 1)

    def freeze(self) -> Tuple[Graph, np.ndarray]:
        src = np.concatenate([np.atleast_1d(np.asarray(s)) for s in self._src]) \
            if self._src else np.zeros(0, self.node_dtype)
        dst = np.concatenate([np.atleast_1d(np.asarray(d)) for d in self._dst]) \
            if self._dst else np.zeros(0, self.node_dtype)
        return from_edges(src, dst, self._num_nodes,
                          self.node_dtype, self.edge_dtype)


# ---------------------------------------------------------------------------
# Derived host-side views
# ---------------------------------------------------------------------------

def to_undirected(src: np.ndarray, dst: np.ndarray,
                  dedup: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrize an edge list (both directions, self-loops once)."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    if dedup:
        pairs = np.unique(np.stack([s, d], axis=1), axis=0)
        s, d = pairs[:, 0], pairs[:, 1]
    return s, d


def degrees_np(g: Graph) -> Dict[str, Any]:
    """Host-side degree stats for loader validation (M0 smoke check)."""
    begin = np.asarray(g.begin)
    deg = np.diff(begin)
    return dict(
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        max_out_degree=int(deg.max(initial=0)),
        mean_out_degree=float(deg.mean()) if deg.size else 0.0,
    )
