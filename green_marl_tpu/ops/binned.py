"""Degree-binned batched edge-map engine (the batched hot path).

This is the performance core that replaces the reference's generated
OpenMP CSR loops (``src/backend_cpp/gm_cpp_gen_foreach.cc:33-328``) and
the per-thread atomic reductions (``gm_cpp_gen.cc:1526-1561``) for the
*batched* execution mode (SURVEY.md §2.10 "batched instances" — the
north-star capability the reference lacks).

Why this shape: a **row gather** (contiguous B-wide rows of a
``[N, B]`` table) moves B instances' worth of payload per index read,
so the per-index cost of a random access is paid once for all B
instances, and no scatter (which serializes or goes atomic on
duplicate indices) is needed anywhere.

So every neighborhood reduction is expressed as: gather *rows* of a node
table ``[n_rows, B]`` (B = batched instances in lanes) at per-edge-slot
indices, then reduce contiguous fixed-width segments with a dense
``reshape(-1, W, B)`` reduction that XLA fuses into the gather.

Fixed-width segments come from **degree binning**: nodes are relabeled
(grouped) by ceil-pow2 of their neighbor count, and every node's slot run
is padded to its bin width ``W``; padded slots point at a dedicated
identity row of the table.  Nodes with degree > ``W_MAX`` ("hubs") get
``ceil(d / W_MAX)`` chunks and a tiny second-stage segment reduction.
The relabeling exists only in the static slot arrays (indices are
pre-composed with the permutation), so the steady-state loop does no
runtime permutes — the same trick as the reference's node-key remapping
(``gm_graph.h:396-436``), applied to degree classes instead of key
compaction.  Shoal's per-array placement decision (replicate/distribute,
``run.sh:66-105``) maps to: slot arrays are streamed, tables are the
only random-access arrays, and both live in HBM in binned order.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph, round_up

# Top bin width: hubs beyond this get chunked + second-stage reduce.
W_MAX = 4096

def _bor_reduce(x, axis):
    """Bitwise-OR reduction (for bit-packed instance planes)."""
    return jax.lax.reduce(x, np.zeros((), x.dtype)[()],
                          jax.lax.bitwise_or, (axis,))


_REDUCE = {
    "sum": (jnp.sum, 0),
    "min": (jnp.min, None),   # identity depends on dtype
    "max": (jnp.max, None),
    "or": (jnp.max, 0),       # boolean OR as max over {0,1}
    "bor": (_bor_reduce, 0),  # bitwise OR (uint8/uint32 bit planes)
}


def op_identity(op: str, dtype) -> np.generic:
    dtype = np.dtype(dtype)
    if op in ("sum", "or", "bor"):
        return dtype.type(0)
    big = np.inf if dtype.kind == "f" else np.iinfo(dtype).max
    small = -np.inf if dtype.kind == "f" else np.iinfo(dtype).min
    return dtype.type(big if op == "min" else small)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BinnedPull:
    """Static slot schedule for one traversal direction of one graph.

    ``slot_src[s]`` is the *binned* row index of the neighbor gathered at
    slot ``s`` (identity row for pads).  Bin ``k`` owns slots
    ``[slot_off_k, slot_off_k + count_k * width_k)`` and produces output
    rows ``[row_off_k, row_off_k + count_k)``.  Hub chunks live at the
    tail of the slot array; ``hub_owner[c]`` is the hub-local output row
    of chunk ``c``.
    """

    slot_src: jax.Array      # [S_tot] int32, binned neighbor row per slot
    slot_edge: jax.Array     # [S_tot] int32, CSC/CSR slot per slot (pad=e_pad)
    hub_owner: jax.Array     # [n_hub_chunks] int32 (hub-local row)
    perm: jax.Array          # [N] int32: perm[row] = original node id
    inv_perm: jax.Array      # [N] int32: inv_perm[orig] = binned row

    # static schedule
    bins: Tuple[Tuple[int, int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True))   # (width, count, slot_off, row_off)
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_hub: int = dataclasses.field(metadata=dict(static=True))
    hub_row_off: int = dataclasses.field(metadata=dict(static=True))
    n_hub_chunks: int = dataclasses.field(metadata=dict(static=True))
    e_pad: int = dataclasses.field(metadata=dict(static=True))
    w_max: int = dataclasses.field(metadata=dict(static=True))

    @property
    def ident_row(self) -> int:
        """Row index of the dedicated identity row."""
        return self.n_rows - 1

    # ---- table management -------------------------------------------------
    def make_table(self, rows_binned: jax.Array, ident) -> jax.Array:
        """Pad a [n_nodes, B] binned array into a [n_rows, B] table with
        pad + identity rows set to ``ident``."""
        b = rows_binned.shape[1]
        pad = self.n_rows - rows_binned.shape[0]
        return jnp.concatenate(
            [rows_binned,
             jnp.full((pad, b), ident, rows_binned.dtype)], axis=0)

    def pin_identity(self, table: jax.Array, ident) -> jax.Array:
        """Restore pad/identity rows after an elementwise table update."""
        rows = jnp.arange(table.shape[0], dtype=jnp.int32)[:, None]
        return jnp.where(rows < self.n_nodes, table,
                         jnp.full((), ident, table.dtype))

    def node_rows_mask(self) -> jax.Array:
        """[n_rows, 1] bool — True for real node rows."""
        return (jnp.arange(self.n_rows, dtype=jnp.int32) <
                self.n_nodes)[:, None]

    def to_binned(self, x: jax.Array) -> jax.Array:
        """Reorder a node-indexed array ([N_any, ...]) into binned row
        order ([n_nodes, ...]).  One row gather — use at algorithm entry
        only, not inside the superstep loop."""
        return x[self.perm]

    def from_binned(self, rows: jax.Array) -> jax.Array:
        """Inverse of ``to_binned`` (algorithm exit)."""
        return rows[self.inv_perm]


def build_binned(offsets: np.ndarray, neigh: np.ndarray,
                 num_nodes: int, e_pad: int,
                 w_max: int = W_MAX) -> BinnedPull:
    """Host-side construction of the slot schedule from a CSC/CSR view.

    ``offsets``: [N+1]; ``neigh``: [>=offsets[-1]] neighbor per slot.
    Direction semantics are the caller's: pass (r_begin, r_node_idx) for
    in-neighbor pulls, (begin, node_idx) for out-neighbor pulls.
    """
    offsets = np.asarray(offsets)
    neigh = np.asarray(neigh)
    N = int(num_nodes)
    deg = np.diff(offsets[:N + 1]).astype(np.int64)

    # width ladder with ~1.25x steps (1,2,3,4,5,7,9,11,... w_max):
    # cuts slot padding from ~1.55x E (pow2) to ~1.10x E at LJ scale,
    # and every padded slot is a gathered row
    lad = set()
    w = 1.0
    while w <= w_max:
        lad.add(int(np.ceil(w)))
        w *= 1.25
    lad.add(int(w_max))
    ladder = sorted(lad)
    lad = np.asarray(ladder, np.int64)
    cls = np.searchsorted(lad, np.maximum(deg, 1)).astype(np.int32)
    max_cls = len(ladder) - 1
    is_hub = deg > w_max

    # binned order: non-hubs grouped by class ascending, hubs last;
    # stable within groups (original id ascending)
    sort_key = np.where(is_hub, max_cls + 1, cls)
    order = np.argsort(sort_key, kind="stable").astype(np.int32)
    inv_order = np.empty(N, np.int32)
    inv_order[order] = np.arange(N, dtype=np.int32)

    n_hub = int(is_hub.sum())
    n_rows = round_up(N + 1, 8)
    ident_row = n_rows - 1

    # map neighbor original-id -> binned row (graph sentinel id N -> ident)
    nbr_map = np.empty(N + 1, np.int32)
    nbr_map[:N] = inv_order
    nbr_map[N] = ident_row

    slot_src_parts = []
    slot_edge_parts = []
    bins = []
    slot_off = 0
    row_off = 0
    for k in range(max_cls + 1):
        W = ladder[k]
        sel = order[(sort_key[order] == k)]
        cnt = int(sel.shape[0])
        if cnt == 0:
            # keep zero-count bins out of the schedule entirely
            continue
        base = offsets[sel].astype(np.int64)
        d = deg[sel]
        pos = np.arange(W, dtype=np.int64)[None, :]
        eidx = base[:, None] + pos                      # [cnt, W]
        valid = pos < d[:, None]
        eidx_c = np.where(valid, eidx, 0)
        srcs = np.where(valid, neigh[eidx_c], N)        # sentinel when pad
        slot_src_parts.append(nbr_map[srcs].ravel())
        slot_edge_parts.append(
            np.where(valid, eidx, e_pad).astype(np.int32).ravel())
        bins.append((W, cnt, slot_off, row_off))
        slot_off += cnt * W
        row_off += cnt

    # hubs: chunked at w_max
    hub_sel = order[sort_key[order] == max_cls + 1]
    hub_row_off = row_off
    if n_hub:
        d = deg[hub_sel]
        chunks = ((d + w_max - 1) // w_max).astype(np.int64)
        n_chunks = int(chunks.sum())
        owner = np.repeat(np.arange(n_hub, dtype=np.int32), chunks)
        # chunk-local base offset within each hub's run
        chunk_pos = (np.arange(n_chunks, dtype=np.int64)
                     - np.repeat(np.cumsum(chunks) - chunks, chunks))
        base = offsets[hub_sel].astype(np.int64)
        cbase = np.repeat(base, chunks) + chunk_pos * w_max
        limit = np.repeat(base + d, chunks)
        pos = np.arange(w_max, dtype=np.int64)[None, :]
        eidx = cbase[:, None] + pos
        valid = eidx < limit[:, None]
        eidx_c = np.where(valid, eidx, 0)
        srcs = np.where(valid, neigh[eidx_c], N)
        slot_src_parts.append(nbr_map[srcs].ravel())
        slot_edge_parts.append(
            np.where(valid, eidx, e_pad).astype(np.int32).ravel())
        hub_owner = owner
    else:
        n_chunks = 0
        hub_owner = np.zeros(0, np.int32)

    slot_src = (np.concatenate(slot_src_parts) if slot_src_parts
                else np.zeros(0, np.int32)).astype(np.int32)
    slot_edge = (np.concatenate(slot_edge_parts) if slot_edge_parts
                 else np.zeros(0, np.int32)).astype(np.int32)

    # leaves stay host-side numpy: callers move them to the device with
    # ONE jax.device_put(bp) (or device_put_lite)
    return BinnedPull(
        slot_src=slot_src,
        slot_edge=slot_edge,
        hub_owner=hub_owner,
        perm=order,
        inv_perm=inv_order,
        bins=tuple(bins),
        n_nodes=N,
        n_rows=n_rows,
        n_hub=n_hub,
        hub_row_off=hub_row_off,
        n_hub_chunks=n_chunks,
        e_pad=int(e_pad),
        w_max=int(w_max),
    )


def binned_in(g: Graph, w_max: int = W_MAX) -> BinnedPull:
    """Pull over in-neighbors (CSC): out[v] = reduce over {w : w->v}."""
    return build_binned(np.asarray(g.r_begin), np.asarray(g.r_node_idx),
                        g.num_nodes, g.e_pad, w_max)


def binned_out(g: Graph, w_max: int = W_MAX) -> BinnedPull:
    """Pull over out-neighbors (CSR): out[v] = reduce over {w : v->w}."""
    return build_binned(np.asarray(g.begin), np.asarray(g.node_idx),
                        g.num_nodes, g.e_pad, w_max)


# ---------------------------------------------------------------------------
# The edge map
# ---------------------------------------------------------------------------

def edge_map(bp: BinnedPull, table: jax.Array, op: str = "sum",
             slot_vals: Optional[jax.Array] = None,
             combine=None, slot_chunk: Optional[int] = None
             ) -> jax.Array:
    """Batched neighborhood reduction.

    ``table``: [n_rows, B] node table in binned order with identity
    rows maintained (see ``make_table`` / ``pin_identity``).
    ``slot_vals``: optional [S_tot, 1-or-B] per-slot values (e.g. edge
    weights laid out by ``slot_edge``) combined into the gathered rows
    with ``combine`` (default: add for min/max — relaxation — and
    multiply for sum).
    ``slot_chunk``: optional cap on slots gathered per XLA buffer —
    bins larger than this split along the node axis (output rows are
    disjoint, so chunks just become extra concat parts).  Caps the
    gather transient at ``slot_chunk * row_bytes``; used by the paged
    wide-plane BFS where a full-bin gather would exceed HBM.  None
    (default) gathers each bin in one buffer.

    Returns a new [n_rows, B] table: per binned node, the ``op``
    reduction over its neighbors' table rows; pad/identity rows hold the
    op identity.
    """
    reduce_fn, _ = _REDUCE[op]
    B = table.shape[1]
    ident = op_identity(op, table.dtype)
    if combine is None:
        combine = (lambda x, w: x + w) if op in ("min", "max") \
            else (lambda x, w: x * w)

    parts = []
    for (W, cnt, soff, roff) in bp.bins:
        cnt_ch = cnt
        if slot_chunk is not None and cnt * W > slot_chunk:
            cnt_ch = max(slot_chunk // W, 1)
        for c0 in range(0, cnt, cnt_ch):
            cc = min(cnt_ch, cnt - c0)
            s0 = soff + c0 * W
            ids = bp.slot_src[s0:s0 + cc * W]
            rows = table[ids]
            if slot_vals is not None:
                w = slot_vals[s0:s0 + cc * W]
                rows = combine(rows, w if w.ndim > 1 else w[:, None])
            parts.append(reduce_fn(rows.reshape(cc, W, B), axis=1))

    if bp.n_hub_chunks:
        soff0 = int(bp.slot_src.shape[0]) - bp.n_hub_chunks * bp.w_max
        h_ch = bp.n_hub_chunks
        if slot_chunk is not None and h_ch * bp.w_max > slot_chunk:
            h_ch = max(slot_chunk // bp.w_max, 1)
        hub_acc = None
        comb2 = {"sum": jnp.add, "min": jnp.minimum,
                 "max": jnp.maximum, "or": jnp.maximum,
                 "bor": (lambda a, b: a | b)}[op]
        for h0 in range(0, bp.n_hub_chunks, h_ch):
            hc = min(h_ch, bp.n_hub_chunks - h0)
            s0 = soff0 + h0 * bp.w_max
            ids = bp.slot_src[s0:s0 + hc * bp.w_max]
            rows = table[ids]
            if slot_vals is not None:
                w = slot_vals[s0:s0 + hc * bp.w_max]
                rows = combine(rows, w if w.ndim > 1 else w[:, None])
            chunk_red = reduce_fn(
                rows.reshape(hc, bp.w_max, B), axis=1)
            owners = bp.hub_owner[h0:h0 + hc]
            if op == "bor":
                # bitwise OR across chunks: segment_max per bit plane
                bits = np.dtype(table.dtype).itemsize * 8
                acc = jnp.zeros((bp.n_hub, B), table.dtype)
                for i in range(bits):
                    plane = (chunk_red >> i) & jnp.ones((), table.dtype)
                    m = jax.ops.segment_max(plane, owners,
                                            num_segments=bp.n_hub,
                                            indices_are_sorted=True)
                    acc = acc | (m << i)
                hub_part = acc
            else:
                seg = {"sum": jax.ops.segment_sum,
                       "min": jax.ops.segment_min,
                       "max": jax.ops.segment_max,
                       "or": jax.ops.segment_max}[op]
                hub_part = seg(chunk_red, owners,
                               num_segments=bp.n_hub,
                               indices_are_sorted=True)
            # hub segments may span slot chunks: combine partials with
            # the op itself (associative); identities fill untouched
            # rows so the combine is safe
            hub_acc = hub_part if hub_acc is None else \
                comb2(hub_acc, hub_part)
        if op == "min" and np.dtype(table.dtype).kind != "f":
            pass  # segment_min identity for ints is dtype max — fine
        parts.append(hub_acc.astype(table.dtype))

    body = jnp.concatenate(parts, axis=0) if parts else \
        jnp.zeros((0, B), table.dtype)
    pad = bp.n_rows - body.shape[0]
    return jnp.concatenate(
        [body, jnp.full((pad, B), ident, table.dtype)], axis=0)


def to_arrays(bp: BinnedPull) -> dict:
    """Flatten to a dict of numpy arrays for np.savez — the analog of
    the reference's one-time convert-to-binary step (README.md:28-33):
    build the schedule once, reload it per run."""
    d = {f: np.asarray(getattr(bp, f))
         for f in ("slot_src", "slot_edge", "hub_owner", "perm",
                   "inv_perm")}
    d["bins"] = np.asarray(bp.bins, np.int64).reshape(-1, 4)
    d["meta"] = np.asarray([bp.n_nodes, bp.n_rows, bp.n_hub,
                            bp.hub_row_off, bp.n_hub_chunks, bp.e_pad,
                            bp.w_max], np.int64)
    return d


def from_arrays(d) -> BinnedPull:
    meta = [int(x) for x in np.asarray(d["meta"])]
    return BinnedPull(
        slot_src=d["slot_src"], slot_edge=d["slot_edge"],
        hub_owner=d["hub_owner"], perm=d["perm"],
        inv_perm=d["inv_perm"],
        bins=tuple(tuple(int(v) for v in row)
                   for row in np.asarray(d["bins"])),
        n_nodes=meta[0], n_rows=meta[1], n_hub=meta[2],
        hub_row_off=meta[3], n_hub_chunks=meta[4], e_pad=meta[5],
        w_max=meta[6])


def device_put_lite(bp: BinnedPull, with_edges: bool = False):
    """Move the schedule to the device, skipping ``slot_edge`` (needed
    only for edge-weighted maps) unless requested — it is as large as
    ``slot_src`` and pure transfer cost otherwise.  The skip leaves an
    EMPTY sentinel so an edge-weighted map on a lite schedule fails
    loudly in ``edge_slot_vals`` instead of gathering garbage."""
    se = (np.asarray(bp.slot_edge) if with_edges
          else np.zeros(0, np.int32))
    return jax.device_put(dataclasses.replace(
        bp, slot_src=np.asarray(bp.slot_src), slot_edge=se,
        hub_owner=np.asarray(bp.hub_owner),
        perm=np.asarray(bp.perm), inv_perm=np.asarray(bp.inv_perm)))


def edge_slot_vals(bp: BinnedPull, edge_vals: jax.Array,
                   pad_val) -> jax.Array:
    """Lay an [e_pad(+1)]-indexed edge property out in slot order
    ([S_tot]).  Build once per run (static layout); the gather here is
    the slow XLA elementwise gather, so keep it out of superstep loops."""
    if bp.slot_edge.shape[0] != bp.slot_src.shape[0]:
        raise ValueError(
            "edge values requested on a 'lite' schedule (slot_edge was "
            "skipped at transfer); rebuild with "
            "device_put_lite(bp, with_edges=True)")
    ev = jnp.concatenate(
        [edge_vals, jnp.full((1,), pad_val, edge_vals.dtype)])
    idx = jnp.minimum(bp.slot_edge, edge_vals.shape[0])
    return ev[idx]
