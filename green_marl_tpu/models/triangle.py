"""Triangle counting (``apps/src/triangle_counting.gm:1-13``).

Reference semantics (undirected version)::

    Foreach(v) Foreach(u: v.Nbrs)(u > v) Foreach(w: v.Nbrs)(w > u)
        If (w.HasEdgeTo(u)) T += 1;

i.e. every triangle {a<b<c} is counted exactly once; ``HasEdgeTo`` is a
binary search over the semi-sorted neighbor row
(``gm_graph.cc:468``, ``gm_common_neighbor_iter.cc``).

Device formulation: orient the graph into a DAG by **degree order** (ties by
id) — triangle count is orientation-invariant, and degree ordering bounds
the DAG out-degree by ~sqrt(E), collapsing the wedge count vs. the
reference's id ordering.  Then enumerate wedges (b, c) ∈ N⁺(a)² with
slot(c) > slot(b) in a flat index space (no ragged loops, no wedge
materialization: each chunk reconstructs its wedges from a cumulative-pair
prefix via binary search) and tests c ∈ N⁺(b) by binary search.  All
reduction is a fixed-order sum — no atomics (reference uses an OpenMP
reduction on T).

Past ``_HASH_MIN_W`` wedges the sort-merge join (or, with
``GM_TRI_MODE=hash``, a bucketed edge hash) replaces the inner binary
search.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph, round_up
from ..utils.limbs import (limb_add, limb_fetch_sum, limb_value,
                           limb_zero)


class DagContext(NamedTuple):
    """Degree-ordered oriented DAG in CSR form (device arrays).

    Rows are sorted by destination *rank*, so binary-search membership
    works; ``rank`` maps original node id -> orientation rank.
    """
    dag_begin: jax.Array   # [N+1]
    dag_dst: jax.Array     # [D_pad] destination ranks, row-sorted
    pair_cum: jax.Array    # [D_pad+1] cumulative wedge (pair) counts / slot
    num_wedges: int
    num_dag_edges: int


def build_dag_host(begin: np.ndarray, node_idx: np.ndarray,
                   N: int):
    """Host-only DAG build (no device traffic — callers that stay on
    host, like bench cold prep, skip the transfer and fetch-back of the
    DagContext device arrays).  Returns
    ``(dag_begin64, dag_dst[D], pair_cum64, D)`` numpy arrays."""
    from ..graph import native
    nat = native.build_dag(begin, node_idx, N) \
        if native.available() else None
    if nat is not None:
        dag_begin64 = nat[0].astype(np.int64)
        dd = nat[1].astype(np.int64)
        D = dd.shape[0]
        deg_r = np.diff(dag_begin64)
        ds = np.repeat(np.arange(N, dtype=np.int64), deg_r)
    else:
        dst = node_idx.astype(np.int64)
        deg = np.diff(begin).astype(np.int64)
        src = np.repeat(np.arange(N, dtype=np.int64), deg)

        # Orientation rank: ascending degree, ties by id.
        order = np.lexsort((np.arange(N), deg))      # rank -> node
        rank = np.empty(N, np.int64)
        rank[order] = np.arange(N)

        rs, rd = rank[src], rank[dst]
        keep = rs < rd                  # orient low-rank -> high-rank
        ds, dd = rs[keep], rd[keep]
        # dedup parallel edges (multigraphs would over-count)
        codes = np.unique(ds * N + dd)
        ds, dd = codes // N, codes % N
        D = ds.shape[0]
        dag_begin64 = np.zeros(N + 1, np.int64)
        np.cumsum(np.bincount(ds, minlength=N), out=dag_begin64[1:])
        # rows already sorted by (ds, dd) because codes are sorted

    d_pad = round_up(max(D, 1))
    dag_dst = np.full(d_pad, N, np.int64)
    dag_dst[:D] = dd

    row_end = dag_begin64[ds + 1]
    slots = np.arange(D, dtype=np.int64)
    pairs = row_end - slots - 1                   # wedges anchored at slot
    pair_cum = np.zeros(d_pad + 1, np.int64)
    pair_cum[1:D + 1] = np.cumsum(pairs)
    if D < d_pad:
        pair_cum[D + 1:] = pair_cum[D]
    return dag_begin64, dag_dst, pair_cum, D


def build_dag(g: Graph) -> DagContext:
    """Host-side preprocessing, like ``make_reverse_edges``: native
    OpenMP (``gm_build_dag``) with a numpy fallback — both produce the
    identical rank-ordered, deduped, row-sorted DAG, shipped to the
    device with ``device_put``."""
    dag_begin64, dag_dst, pair_cum, D = build_dag_host(
        np.asarray(g.begin), np.asarray(g.node_idx)[: g.num_edges],
        g.num_nodes)
    # int32 on device (x64 off); counts beyond int32 are rejected at the
    # count entry points before these arrays are indexed
    return DagContext(
        dag_begin=jax.device_put(dag_begin64.astype(np.int32)),
        dag_dst=jax.device_put(dag_dst.astype(np.int32)),
        pair_cum=jax.device_put(np.minimum(pair_cum, 2**31 - 1)
                                .astype(np.int32)),
        num_wedges=int(pair_cum[D]),
        num_dag_edges=D,
    )


# ---------------------------------------------------------------------------
# Small-graph fast path (N <= ~64k, wedges <= ~32M): materialize the
# (u, w) wedge endpoints host-side (vectorized numpy expansion) and test
# membership with ONE bit-word gather per wedge against a packed
# adjacency bitmap — vs ~15 serialized gathers for the per-wedge binary
# search.  This is the device answer to the reference's sorted-intersection
# iterator (``gm_cpp_opt_common_nbr.cc``); round-3 verdict item 3:
# parity10k was 10x slower than the reference CPU on the search path.
# Schedules and bitmaps are cached per graph (the reference builds its
# semi-sort/edge indexes once in prepare(), outside the timed region).
# ---------------------------------------------------------------------------

_BITMAP_MAX_N = 1 << 16
_EXPAND_MAX_W = 1 << 25

# tiny keep-alive cache: id(graph) -> (graph_ref, dict of prep blobs)
_PREP_CACHE: dict = {}


def _prep_of(g: Graph) -> dict:
    k = id(g)
    hit = _PREP_CACHE.get(k)
    if hit is not None and hit[0] is g:
        return hit[1]
    if len(_PREP_CACHE) >= 4:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
    d: dict = {}
    _PREP_CACHE[k] = (g, d)
    return d


def _bitword_table(edges_src, edges_dst, n: int) -> jax.Array:
    """[n * W] packed adjacency words: bit (dst % 32) of word
    src * W + dst // 32."""
    W = (n + 31) // 32
    word = edges_src.astype(np.int64) * W + edges_dst // 32
    bit = np.uint32(1) << (edges_dst % 32).astype(np.uint32)
    order = np.argsort(word, kind="stable")
    ws, bs = word[order], bit[order]
    # OR-reduce equal words: segment boundaries
    uniq, start = np.unique(ws, return_index=True)
    acc = np.bitwise_or.reduceat(bs, start) if ws.size else bs
    table = np.zeros(n * W, np.uint32)
    table[uniq] = acc
    return jnp.asarray(table), W


@partial(jax.jit, static_argnames=("w",))
def _count_expanded(table, u, w_arr, valid, w: int):
    word = table[u * w + w_arr // 32]
    hit = ((word >> (w_arr % 32).astype(jnp.uint32)) & 1) > 0
    return jnp.sum((hit & valid).astype(jnp.int64)
                   if False else (hit & valid).astype(jnp.int32))


def _expand_pairs(vals: np.ndarray, base: np.ndarray, cnt: np.ndarray,
                  anchor_vals: np.ndarray):
    """Vectorized wedge expansion: for anchor slot i, pairs are
    (anchor_vals[i], vals[base[i] + t]) for t < cnt[i]."""
    total = int(cnt.sum())
    rep = np.repeat(np.arange(cnt.shape[0], dtype=np.int64), cnt)
    cum = np.zeros(cnt.shape[0], np.int64)
    np.cumsum(cnt[:-1], out=cum[1:])
    off = np.arange(total, dtype=np.int64) - cum[rep]
    u = anchor_vals[rep]
    w_arr = vals[base[rep] + off]
    return u, w_arr


_ANCHOR_STRIDE = 256          # wedge ids per anchor-index sample


def _anchor_samples(cum64: np.ndarray, num_wedges: int) -> np.ndarray:
    """Sampled anchor index: samples[m] = anchor slot of wedge m*256.
    Bounds the per-wedge anchor search to a <=257-slot window (9 steps)
    instead of log2(D) (~25) over the full prefix."""
    marks = np.arange(0, num_wedges + _ANCHOR_STRIDE, _ANCHOR_STRIDE,
                      dtype=np.int64)
    s = np.searchsorted(cum64, np.minimum(marks, num_wedges - 1),
                        side="right") - 1
    s = np.maximum(s, 0).astype(np.int32)
    # window search depth: zero-pair slots (row-last slots) can widen a
    # window far beyond 257 — derive the exact bound
    span = int((s[1:] + 1 - s[:-1]).max(initial=1))
    return s, max(1, span.bit_length()) + 1


# wedges per device dispatch: the driver loops fixed windows with a
# TRACED offset/limit — one compile total, bounded work per dispatch
_DISPATCH_W = 1 << 24


def _quantized_windows(samples_np: np.ndarray, num_wedges: int,
                       chunk: int, max_deg: int, dd_len: int,
                       sm_hint: int = 0):
    """Static (s_max, d_win) for the expansion decode, quantized to
    powers of two (and at least ``sm_hint``) so every sub-range of a
    multi-slice count REUSES one compiled kernel — each distinct static
    arg costs a compile.  None when the slot windows
    are too wide for the decode to pay off."""
    s_max, _ = _window_bounds(samples_np, num_wedges, chunk, max_deg)
    if s_max > 8 * chunk:
        return None
    s_max = max(1 << max(s_max - 1, 1).bit_length(), 1 << 14, sm_hint)
    d_win = s_max + (1 << max(int(max_deg) + 1, 1).bit_length())
    d_win = min(d_win, dd_len)
    s_max = min(s_max, d_win)
    return s_max, d_win


def _window_bounds(samples: np.ndarray, num_wedges: int, chunk: int,
                   max_deg: int) -> Tuple[int, int]:
    """Static window sizes for the expansion decode: the anchor slots of
    any ``chunk`` consecutive wedge ids span at most S_MAX slots, and
    their target slots stay within S_MAX + max row length."""
    n_marks = samples.shape[0]
    k0s = np.arange(0, num_wedges, chunk, dtype=np.int64)
    lo = samples[np.minimum(k0s >> 8, n_marks - 1)].astype(np.int64)
    hi_idx = np.minimum(((k0s + chunk - 1) >> 8) + 1, n_marks - 1)
    hi = samples[hi_idx].astype(np.int64) + 1
    s_max = int((hi - lo).max(initial=1))
    return s_max, s_max + max_deg + 2


@partial(jax.jit, static_argnames=("chunk", "bits", "s_max", "d_win"))
def _count_wedges_expand(dag_begin, dag_dst, pair_cum, samples, k0,
                         n_limit, pc_base, chunk: int, bits: int,
                         s_max: int, d_win: int) -> jax.Array:
    """Expansion decode: within a chunk of consecutive wedge ids the
    anchor slot is NON-DECREASING, so instead of a per-wedge binary
    search the kernel dynamic-slices the [s_max] slot window, scatters
    anchor-start marks into the chunk, and prefix-sums them — zero
    random HBM gathers for the decode, and both wedge endpoints read
    from the same sliced dag_dst window.  Only the row-membership
    search still gathers from HBM at random (~13 vs ~25 gathers/wedge
    of the search decode)."""
    n = dag_begin.shape[0] - 1
    num_chunks = _DISPATCH_W // chunk
    n_marks = samples.shape[0]

    def row_contains(b, c):
        lo = dag_begin[b]
        hi = dag_begin[b + 1]

        def body(_, state):
            lo, hi = state
            active = lo < hi
            mid = (lo + hi) // 2
            v = dag_dst[jnp.clip(mid, 0, dag_dst.shape[0] - 1)]
            go_right = active & (v < c)
            return (jnp.where(go_right, mid + 1, lo),
                    jnp.where(active & ~go_right, mid, hi))

        lo, hi = jax.lax.fori_loop(0, bits, body, (lo, hi))
        return (lo < dag_begin[b + 1]) & \
            (dag_dst[jnp.clip(lo, 0, dag_dst.shape[0] - 1)] == c)

    def do_chunk(ci, acc):
        k_start = k0 + ci * chunk
        i0 = samples[jnp.minimum(k_start >> 8, n_marks - 1)]
        i0 = jnp.minimum(i0, pc_base + pair_cum.shape[0] - s_max)
        pc_win = jax.lax.dynamic_slice_in_dim(
            pair_cum, jnp.maximum(i0 - pc_base, 0), s_max)
        pos = pc_win.astype(jnp.int32) - k_start       # [s_max]
        base = jnp.sum((pos <= 0).astype(jnp.int32))
        inb = (pos >= 1) & (pos < chunk)
        marks = jnp.zeros((chunk,), jnp.int32).at[
            jnp.clip(pos, 0, chunk - 1)].add(
            jnp.where(inb, 1, 0), mode="drop")
        inc = jnp.cumsum(marks)                        # [chunk]
        i = i0 + base - 1 + inc                        # anchor per wedge
        k = k_start + jnp.arange(chunk, dtype=jnp.int32)
        valid = k < n_limit
        il = jnp.clip(i - i0, 0, s_max - 1)
        off = k - pc_win[il]
        dd_win = jax.lax.dynamic_slice_in_dim(
            dag_dst, jnp.minimum(i0, dag_dst.shape[0] - d_win), d_win)
        dbase = jnp.minimum(i0, dag_dst.shape[0] - d_win)
        b = dd_win[jnp.clip(i - dbase, 0, d_win - 1)]
        j = i + 1 + off
        c = dd_win[jnp.clip(j - dbase, 0, d_win - 1)]
        hit = row_contains(b, c) & valid
        return limb_add(acc, jnp.sum(hit.astype(jnp.int32)))

    return jax.lax.fori_loop(0, num_chunks, do_chunk, limb_zero())


# ---------------------------------------------------------------------------
# Hashed membership: the binary search costs ~13 DEPENDENT random-gather
# rounds per wedge (log2 max_deg).  A bucketed hash of all DAG edges
# (b, c) answers membership in ONE fixed gather round: 64 key pairs per
# bucket = one contiguous 512 B row gathered per probe, compared
# 128-wide.  Build is native OpenMP (gm_hash_fill_wide) with a
# vectorized-numpy fallback, cached like the DAG itself (the reference
# builds its edge indexes once in prepare() too, gm_graph.cc:205-296).
# ---------------------------------------------------------------------------

_HB = 64                     # key pairs per bucket (one 512 B row fetch)
# Empty-slot sentinel: 0xFFFFFF (not -1; the native fill writes the
# same value, gm_hash_fill_wide).  Safe at ANY graph scale: the
# probe is pure (b, c) equality, queries always have b < c (strict
# rank order), and an empty slot holds the pair (E, E) with b == c —
# unreachable by any query.
_H_EMPTY = np.int32(0xFFFFFF)
# hashed membership pays a table build + ~2x edge memory; profitable
# once the wedge space dwarfs the edge set (tests shrink this)
_HASH_MIN_W = 1 << 26


def _mix_hash(b, c, seed, nbuckets, xp=np):
    """Multiplicative mix of the (b, c) pair -> bucket id; identical
    uint32 arithmetic on host (numpy) and device (jnp)."""
    u = (b.astype(xp.uint32) * xp.uint32(0x9E3779B1)
         ^ c.astype(xp.uint32) * xp.uint32(0x85EBCA77)
         ^ xp.uint32(seed))
    u = u ^ (u >> xp.uint32(16))
    u = u * xp.uint32(0xC2B2AE35)
    u = u ^ (u >> xp.uint32(13))
    # arbitrary (non-power-of-two) bucket counts keep the table at
    # D/alpha slots instead of rounding up to 2x; the uint32 modulo is
    # one multiply-shift on the VPU
    return (u % xp.uint32(nbuckets)).astype(xp.int32)


class EdgeHash(NamedTuple):
    wide: np.ndarray        # [Hw, 2*_HB] int32, slot j -> (b, c) at 2j, 2j+1
    seed: int


def _fill_table(b, c, h, nbuckets, slots=_HB):
    """Place keys into [nbuckets, slots] buckets; returns (table,
    overflow mask).  Vectorized: sort by bucket, rank within bucket,
    first ``slots`` fit."""
    order = np.argsort(h, kind="stable")
    hs = h[order]
    uniq, start, cnt = np.unique(hs, return_index=True,
                                 return_counts=True)
    first = np.zeros(hs.shape[0], np.int64)
    first[start] = start
    np.maximum.accumulate(first, out=first)
    rank = np.arange(hs.shape[0], dtype=np.int64) - first
    fits = rank < slots
    table = np.full((nbuckets, 2 * slots), _H_EMPTY, np.int32)
    slot = hs[fits].astype(np.int64) * slots + rank[fits]
    flat = table.reshape(-1, 2)
    flat[slot, 0] = b[order][fits]
    flat[slot, 1] = c[order][fits]
    over = np.zeros(h.shape[0], bool)
    over[order] = ~fits
    return table, over


_H_SEEDS = (0x1234ABCD, 0x7F4A7C15, 0x2545F491, 0x0DEADBEE)


def build_edge_hash(ctx: DagContext, alpha: float = 0.5) -> EdgeHash:
    """One-level wide bucketed hash of every DAG edge
    (src_rank, dst_rank): ``_HB`` = 64 key pairs per bucket, one bucket
    = one 512 B row, load ``alpha`` (mean occupancy 32 at 0.5 —
    P(bucket overflow) ~ Poisson(32) beyond 64 ≈ 1e-7, so a handful of
    seed retries finds a zero-overflow table; same 16 bytes/key
    footprint as the earlier two-level design with HALF the probe
    gathers)."""
    dag_begin = np.asarray(ctx.dag_begin).astype(np.int64)
    D = ctx.num_dag_edges
    c = np.asarray(ctx.dag_dst)[:D].astype(np.int32)
    n = dag_begin.shape[0] - 1
    hw = max(int(D / alpha / _HB) + 1, 8)

    from ..graph import native
    if native.available():
        for seed in _H_SEEDS:
            r = native.hash_fill_wide(dag_begin.astype(np.int32), c, n,
                                      D, hw, _HB, seed)
            if r is None:
                break
            wide, fail = r
            if fail == 0:
                if int(wide.min(initial=0)) < 0:
                    # a pre-0xFFFFFF-sentinel .so would poison the
                    # versioned triangle cache with -1 fills
                    raise RuntimeError(
                        "libgmtpu_io.so is stale (old hash sentinel); "
                        "run: make -C native -B")
                return EdgeHash(wide=wide, seed=seed)
        else:
            raise RuntimeError(
                f"edge-hash build: overflow after {len(_H_SEEDS)} seeds")

    deg = np.diff(dag_begin)
    b = np.repeat(np.arange(n, dtype=np.int32), deg)
    for seed in _H_SEEDS:
        h1 = _mix_hash(b, c, seed, hw)
        wide, over = _fill_table(b, c, h1, hw)
        if not over.any():
            return EdgeHash(wide=wide, seed=seed)
    raise RuntimeError(
        f"edge-hash build: overflow after {len(_H_SEEDS)} seeds")


def descending_row_layout(dag_begin: np.ndarray, dag_dst: np.ndarray,
                          D: int):
    """Rows reordered by DESCENDING pair count, host-side.

    The hashed membership probe never touches ``dag_begin`` — row order
    is free — and rank order puts millions of 0-2-pair rows first, so
    the expansion decode's anchor window ``s_max`` balloons (1M slots on
    LJ slice 1).  Descending-pair order
    keeps every chunk's anchor window compact AND uniform across
    slices.  Returns (perm_dst, cum64) where cum64 is the exact wedge
    prefix over the permuted slot axis."""
    from ..graph import native
    n = dag_begin.shape[0] - 1
    nat = native.desc_layout(dag_begin, dag_dst, n, D) \
        if native.available() else None
    if nat is not None:
        perm_dst, nb = nat
        starts = nb.astype(np.int64)
        new_deg = np.diff(starts)
        total = int(starts[-1])
    else:
        begin64 = dag_begin.astype(np.int64)
        deg = np.diff(begin64)
        pairs_row = deg * (deg - 1) // 2
        order = np.argsort(-pairs_row, kind="stable")
        new_deg = deg[order]
        total = int(new_deg.sum())
        starts = np.zeros(order.shape[0] + 1, np.int64)
        np.cumsum(new_deg, out=starts[1:])
        rep = np.repeat(np.arange(order.shape[0], dtype=np.int64),
                        new_deg)
        offs = np.arange(total, dtype=np.int64) - starts[rep]
        old_slot = begin64[order[rep]] + offs
        perm_dst = dag_dst[old_slot]
    rep = np.repeat(np.arange(n, dtype=np.int64), new_deg)
    offs = np.arange(total, dtype=np.int64) - starts[rep]
    pairs = new_deg[rep] - offs - 1
    cum = np.zeros(total + 1, np.int64)
    cum[1:] = np.cumsum(pairs)
    return perm_dst.astype(np.int32), cum, starts


# ---------------------------------------------------------------------------
# d-shift kernel for SPARSE row classes.  The window decode pays
# ~s_max/chunk scatter elements per wedge — ruinous where anchors
# advance ~1 slot/wedge (tail rows of 1-8 pairs).  Enumerating by
# (slot, shift) instead makes both
# endpoints CONTIGUOUS SLICES: wedge (s, s+d) for d <= pairs[s]; for
# each shift d the eligible slots are a prefix [0, R_d) because the
# descending-pair row layout sorts rows by length, so the host emits
# (d, slot0) chunk descriptors and the kernel needs ZERO decode
# gathers — only the bucket probe (~2 lanes/wedge x 1 gather vs the
# window decode's 4 slots x 4 scatters).  No pc/samples transfers, no
# per-class compiles.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("d_len",))
def _pairs_on_device(db_dev, d_len: int):
    """Per-slot pair count from the (permuted-layout) row offsets,
    computed on device: scatter each row's END at its start slot,
    forward-fill with cummax, subtract slot index.  Padding slots get
    negative pairs (auto-invalid).  Jitted: eager execution would
    dispatch and materialize every op separately on E-sized arrays."""
    ends = jnp.zeros((d_len,), jnp.int32).at[
        jnp.clip(db_dev[:-1], 0, d_len - 1)].max(
        db_dev[1:], mode="drop")
    rowend = jax.lax.cummax(ends)
    return rowend - jnp.arange(d_len, dtype=jnp.int32) - 1


@partial(jax.jit, static_argnames=("chunk", "seed"))
def _count_wedges_shift(dd, pairs, desc, wide, c0, chunk: int,
                        seed: int) -> jax.Array:
    """One dispatch of ``_DISPATCH_W // chunk`` descriptor-driven
    chunks: descriptor (d, slot0) -> lanes s = slot0+[0,chunk), wedge
    (dd[s], dd[s+d]) valid iff pairs[s] >= d, membership by the wide
    bucket probe.  ``dd``/``pairs`` must be padded so slot0+d+chunk
    never clamps (caller guarantees)."""
    num_chunks = _DISPATCH_W // chunk
    hw = wide.shape[0]

    def do_chunk(ci, acc):
        de = desc[c0 + ci]
        d, s0 = de[0], de[1]
        b = jax.lax.dynamic_slice_in_dim(dd, s0, chunk)
        c = jax.lax.dynamic_slice_in_dim(dd, s0 + d, chunk)
        pr = jax.lax.dynamic_slice_in_dim(pairs, s0, chunk)
        valid = pr >= d
        h1 = _mix_hash(b, c, seed, hw, xp=jnp)
        rows = wide[h1]
        kb = rows[:, 0::2]
        kc = rows[:, 1::2]
        hit = jnp.any((kb == b[:, None]) & (kc == c[:, None]), axis=1)
        return limb_add(acc, jnp.sum((hit & valid).astype(jnp.int32)))

    return jax.lax.fori_loop(0, num_chunks, do_chunk, limb_zero())


def _shift_pieces(dag_begin_np: np.ndarray, s_cut: int, D: int,
                  chunk: int) -> np.ndarray:
    """Host-side (d, slot0) chunk descriptors covering every wedge
    anchored at slots [s_cut, D).  Rows are length-sorted descending,
    so slots with pairs >= d all lie below R_d = end of the prefix of
    rows with length > d."""
    lens = np.diff(dag_begin_np.astype(np.int64))
    lens = lens[lens > 0]
    max_len = int(lens.max(initial=1))
    pieces = []
    for d in range(1, max_len):
        # rows with len >= d+1 form a prefix (lens descending)
        r_cnt = int(np.searchsorted(-lens, -(d + 1), side="right"))
        r_d = int(dag_begin_np[r_cnt])
        if r_d <= s_cut:
            continue
        for s0 in range(s_cut, r_d, chunk):
            pieces.append((d, s0))
    if not pieces:
        return np.zeros((0, 2), np.int32)
    return np.asarray(pieces, np.int32)


def _count_shift_region(dd_dev, db_dev, wide_dev, seed: int,
                        dag_begin_np: np.ndarray, s_cut: int, D: int,
                        chunk: int = 1 << 17):
    """Count all wedges anchored at slots >= ``s_cut`` with the d-shift
    kernel; returns the pending limb sums, one per dispatch.
    ``dd_dev`` is padded on device so the shifted slice never clamps."""
    pieces = _shift_pieces(dag_begin_np, s_cut, D, chunk)
    n_p = pieces.shape[0]
    if n_p == 0:
        return []
    per = _DISPATCH_W // chunk
    n_disp = -(-n_p // per)
    pad = n_disp * per - n_p
    if pad:
        # sentinel descriptors: d > any pairs value -> all-invalid
        sent = np.tile(np.asarray([[1 << 29, 0]], np.int32), (pad, 1))
        pieces = np.concatenate([pieces, sent])
    max_d = int(pieces[:, 0][pieces[:, 0] < (1 << 29)].max(initial=1))
    need = int(pieces[:, 1].max(initial=0)) + chunk + max_d
    if int(dd_dev.shape[0]) < need:
        dd_dev = jnp.concatenate([
            dd_dev, jnp.full((need - int(dd_dev.shape[0]),),
                             jnp.int32(2 ** 31 - 2), jnp.int32)])
    pairs = _pairs_on_device(db_dev, int(dd_dev.shape[0]))
    desc = jax.device_put(pieces)
    pending = []
    for di in range(n_disp):
        pending.append(_count_wedges_shift(
            dd_dev, pairs, desc, wide_dev,
            jnp.asarray(di * per, jnp.int32), chunk, seed))
    return pending


# ---------------------------------------------------------------------------
# Sort-merge join: NO random gathers at all.  The hash probe pays one
# 512 B random gather per wedge; here each wedge chunk is joined
# against the DAG edge key set by SORTING: wedge (b, c) =
# (dd[s], dd[s+d]) keys stream from the same contiguous slices as the
# d-shift probe kernel, edges tag lo's low bit (edge even, wedge odd —
# an edge sorts immediately before its wedge run), and run membership
# propagates with two cummaxes.  Which of the two wins on the GPU is
# not measured yet (GM_TRI_MODE selects; ROADMAP 1.4).
# ---------------------------------------------------------------------------

_SM_DISPATCH_W = 1 << 27     # lanes per sort dispatch
_SM_WS = np.int32(1 << 29)   # wedge sentinel (b and c of invalid lanes)
_SM_ES = np.int32((1 << 29) + 1)   # edge pad sentinel (differs from
#                                    _SM_WS so sentinels never join)


@partial(jax.jit, static_argnames=("d_len",))
def _edge_keys_desc(dd, db, order, num_dag_edges, d_len: int):
    """DAG edge keys (rank id, dst) derived ON DEVICE from the
    descending-pair layout: row index per slot via scatter-starts +
    cummax, rank id via one [n]-table lookup.  ``order`` is the
    descending row order (rank ids), host-built by the same stable
    pairs-descending comparator as the layout itself."""
    n_rows = order.shape[0]
    rid0 = jnp.zeros((d_len,), jnp.int32).at[
        jnp.clip(db[:-1], 0, d_len - 1)].max(
        jnp.arange(n_rows, dtype=jnp.int32), mode="drop")
    rid = jax.lax.cummax(rid0)
    ehi = order[jnp.clip(rid, 0, n_rows - 1)]
    slot = jnp.arange(d_len, dtype=jnp.int32)
    valid = slot < num_dag_edges
    ehi = jnp.where(valid, ehi, _SM_ES)
    elo = jnp.where(valid, jnp.minimum(dd, _SM_WS), 0) * 2
    return ehi, elo


@partial(jax.jit, static_argnames=("chunk", "width"))
def _count_wedges_sortmerge(dd, pairs, desc, ehi, elo, c0,
                            chunk: int, width: int):
    """One dispatch of ``width // chunk`` descriptor-driven chunks,
    counted by the gather-free sort-merge join.  Same descriptor
    protocol as ``_count_wedges_shift`` (wedge (s, s+d), valid iff
    pairs[s] >= d); ``ehi``/``elo`` from ``_edge_keys_desc``."""
    num_chunks = width // chunk

    def fill(ci, bufs):
        bb, cc = bufs
        de = desc[c0 + ci]
        d, s0 = de[0], de[1]
        b = jax.lax.dynamic_slice_in_dim(dd, s0, chunk)
        c = jax.lax.dynamic_slice_in_dim(dd, s0 + d, chunk)
        pr = jax.lax.dynamic_slice_in_dim(pairs, s0, chunk)
        valid = pr >= d
        # clamp BEFORE the lo packing: dd pad slots hold 2^31-2, which
        # would overflow int32 when doubled
        b = jnp.where(valid, jnp.minimum(b, _SM_WS), _SM_WS)
        c = jnp.where(valid, jnp.minimum(c, _SM_WS), _SM_WS)
        off = ci * chunk
        bb = jax.lax.dynamic_update_slice_in_dim(bb, b, off, 0)
        cc = jax.lax.dynamic_update_slice_in_dim(cc, c, off, 0)
        return bb, cc

    buf = jnp.zeros((width,), jnp.int32)
    bb, cc = jax.lax.fori_loop(0, num_chunks, fill, (buf, buf))

    hi = jnp.concatenate([ehi, bb])
    lo = jnp.concatenate([elo, cc * 2 + 1])
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    prev_hi = jnp.concatenate([jnp.full((1,), -1, jnp.int32), hi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), -9, jnp.int32), lo[:-1]])
    is_w = (lo & 1) == 1
    start = (hi != prev_hi) | (lo != prev_lo)
    hit_start = start & is_w & (prev_hi == hi) & (prev_lo == lo - 1)
    pos = jnp.arange(hi.shape[0], dtype=jnp.int32)
    last_start = jax.lax.cummax(jnp.where(start & is_w, pos, -1))
    last_hit = jax.lax.cummax(jnp.where(hit_start, pos, -1))
    hit = is_w & (last_hit >= 0) & (last_hit == last_start)
    return limb_add(limb_zero(), jnp.sum(hit.astype(jnp.int32)))


def desc_order(rank_begin: np.ndarray) -> np.ndarray:
    """Rank ids in descending-pair row order — the EXACT order
    ``descending_row_layout`` / native ``gm_desc_layout`` use (stable,
    pairs descending; ties keep ascending rank)."""
    deg = np.diff(rank_begin.astype(np.int64))
    return np.argsort(-(deg * (deg - 1) // 2),
                      kind="stable").astype(np.int32)


def _count_sortmerge_region(dd_dev, db_dev, ehi, elo,
                            dag_begin_np: np.ndarray, s_cut: int,
                            D: int, chunk: int = 1 << 17):
    """Count all wedges anchored at slots >= ``s_cut`` with the
    sort-merge kernel; same pending-limbs result and (d, slot0)
    descriptors as ``_count_shift_region``."""
    pieces = _shift_pieces(dag_begin_np, s_cut, D, chunk)
    n_p = pieces.shape[0]
    if n_p == 0:
        return []
    width = _SM_DISPATCH_W
    while width // chunk > max(n_p, 1) * 2 and width > chunk:
        width //= 2                      # small regions: small sorts
    per = width // chunk
    n_disp = -(-n_p // per)
    pad = n_disp * per - n_p
    if pad:
        sent = np.tile(np.asarray([[1 << 29, 0]], np.int32), (pad, 1))
        pieces = np.concatenate([pieces, sent])
    max_d = int(pieces[:, 0][pieces[:, 0] < (1 << 29)].max(initial=1))
    need = int(pieces[:, 1].max(initial=0)) + chunk + max_d
    if int(dd_dev.shape[0]) < need:
        dd_dev = jnp.concatenate([
            dd_dev, jnp.full((need - int(dd_dev.shape[0]),),
                             jnp.int32(2 ** 31 - 2), jnp.int32)])
    pairs = _pairs_on_device(db_dev, int(dd_dev.shape[0]))
    desc = jax.device_put(pieces)
    pending = []
    for di in range(n_disp):
        pending.append(_count_wedges_sortmerge(
            dd_dev, pairs, desc, ehi, elo,
            jnp.asarray(di * per, jnp.int32), chunk, width))
    return pending


@partial(jax.jit, static_argnames=("chunk", "bits", "span_bits"))
def _count_wedges(dag_begin, dag_dst, pair_cum, samples, k0, n_limit,
                  pc_base, chunk: int, bits: int,
                  span_bits: int) -> jax.Array:
    """Sum over wedge ids [k0, min(k0 + _DISPATCH_W, n_limit)) of
    [c in N+(b)]; flat wedge ids -> (slot, offset) via the sampled
    anchor index + a bounded window search, then membership by binary
    search in row b."""
    n = dag_begin.shape[0] - 1
    num_chunks = _DISPATCH_W // chunk
    # ``bits`` = search depth: log2(max DAG row length), passed in by the
    # caller — degree orientation bounds rows at ~sqrt(E), so this is
    # ~14 HBM gathers per wedge instead of log2(N)+1 (~24)

    def row_contains(b, c):
        lo = dag_begin[b]
        hi = dag_begin[b + 1]

        def body(_, state):
            lo, hi = state
            active = lo < hi
            mid = (lo + hi) // 2
            v = dag_dst[jnp.clip(mid, 0, dag_dst.shape[0] - 1)]
            go_right = active & (v < c)
            return (jnp.where(go_right, mid + 1, lo),
                    jnp.where(active & ~go_right, mid, hi))

        lo, hi = jax.lax.fori_loop(0, bits, body, (lo, hi))
        return (lo < dag_begin[b + 1]) & \
            (dag_dst[jnp.clip(lo, 0, dag_dst.shape[0] - 1)] == c)

    def do_chunk(ci, acc):
        k = k0 + ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        valid = k < n_limit
        kk = jnp.minimum(k, n_limit - 1)
        # anchor slot i: largest i with pair_cum[i] <= kk — bounded
        # search inside the sampled window [samples[m], samples[m+1]]
        m = kk // _ANCHOR_STRIDE
        lo = samples[m]
        hi = samples[m + 1] + 1

        def abody(_, st):
            lo, hi = st
            active = hi - lo > 1
            mid = (lo + hi) // 2
            pcm = pair_cum[jnp.clip(mid - pc_base, 0,
                                    pair_cum.shape[0] - 1)]
            go_left = active & (pcm > kk)
            return (jnp.where(go_left, lo, jnp.where(active, mid, lo)),
                    jnp.where(go_left, mid, hi))

        lo, hi = jax.lax.fori_loop(0, span_bits, abody, (lo, hi))
        i = lo
        off = kk - pair_cum[jnp.clip(i - pc_base, 0,
                                     pair_cum.shape[0] - 1)]
        j = i + 1 + off
        b = dag_dst[i]
        c = dag_dst[j]
        hit = row_contains(b, c) & valid
        return limb_add(acc, jnp.sum(hit.astype(jnp.int32)))

    return jax.lax.fori_loop(0, num_chunks, do_chunk, limb_zero())


def triangle_count(g: Graph, chunk: int = 1 << 20,
                   edge_chunk: int = 1 << 17) -> int:
    """Count triangles of the (undirected, symmetric) graph ``g``.

    Returns a Python int (reference prints ``number of triangles: T``).
    N <= 64k routes to the packed-bitmap intersection (contiguous loads
    + popcount); larger graphs use wedge enumeration + row binary
    search, split into int32-sized wedge sub-ranges when the oriented
    wedge space exceeds 2^31 (round-3 verdict item 3 removed the
    NotImplementedError guard).
    """
    prep = _prep_of(g)
    if "dag" not in prep:
        prep["dag"] = build_dag(g)
    ctx = prep["dag"]
    if ctx.num_wedges == 0:
        return 0
    n = g.num_nodes
    if n <= _BITMAP_MAX_N and ctx.num_wedges <= _EXPAND_MAX_W:
        if "dag_fast" not in prep:
            dag_begin = np.asarray(ctx.dag_begin).astype(np.int64)
            dag_dst = np.asarray(ctx.dag_dst)
            D = ctx.num_dag_edges
            deg = np.diff(dag_begin)
            src = np.repeat(np.arange(n, dtype=np.int64), deg[:n])
            table, W = _bitword_table(src, dag_dst[:D].astype(np.int64),
                                      n)
            row_end = dag_begin[src + 1]
            slots = np.arange(D, dtype=np.int64)
            cnt = row_end - slots - 1
            b, c = _expand_pairs(dag_dst.astype(np.int64),
                                 slots + 1, cnt, dag_dst[:D]
                                 .astype(np.int64))
            wp = round_up(max(b.shape[0], 1))
            bb = np.zeros(wp, np.int32)
            cc = np.zeros(wp, np.int32)
            vv = np.zeros(wp, bool)
            bb[: b.shape[0]] = b
            cc[: c.shape[0]] = c
            vv[: b.shape[0]] = True
            prep["dag_fast"] = (table, W, jnp.asarray(bb),
                                jnp.asarray(cc), jnp.asarray(vv))
        table, W, bb, cc, vv = prep["dag_fast"]
        return int(_count_expanded(table, bb, cc, vv, W))
    deg = np.diff(np.asarray(ctx.dag_begin))
    max_deg = int(deg.max(initial=1))
    bits = max(1, max_deg.bit_length()) + 1
    eh = None
    sm = None
    if ctx.num_wedges >= _HASH_MIN_W:
        import os as _os
        use_sm = _os.environ.get("GM_TRI_MODE", "sortmerge") != "hash"
        if "ctx_perm" not in prep:
            prep["ctx_perm"] = _permuted_ctx(ctx)
        if use_sm:
            # sort-merge join (default): no hash table build or
            # transfer at all; edge keys derive on device from the
            # descending layout + the host-built order table
            if "sm_keys" not in prep:
                order = jnp.asarray(desc_order(
                    np.asarray(ctx.dag_begin)))
                pdd = prep["ctx_perm"].dag_dst
                pdb = prep["ctx_perm"].dag_begin
                ehi, elo = _edge_keys_desc(
                    pdd, pdb, order, jnp.asarray(
                        ctx.num_dag_edges, jnp.int32),
                    int(pdd.shape[0]))
                prep["sm_keys"] = (ehi[: ctx.num_dag_edges],
                                   elo[: ctx.num_dag_edges])
            sm = prep["sm_keys"]
        else:
            if "ehash" not in prep:
                h = build_edge_hash(ctx)
                prep["ehash"] = (jnp.asarray(h.wide), h.seed)
            eh = prep["ehash"]
        # lanes per descriptor chunk of both region kernels
        chunk = min(chunk, 1 << 17)
        ctx = prep["ctx_perm"]
    if sm is not None:
        if "perm_begin_np" not in prep:
            prep["perm_begin_np"] = np.asarray(
                ctx.dag_begin).astype(np.int64)
        pending = _count_sortmerge_region(
            ctx.dag_dst, ctx.dag_begin, sm[0], sm[1],
            prep["perm_begin_np"], 0, ctx.num_dag_edges, chunk)
        return limb_fetch_sum(pending)
    if eh is not None:
        # hashed path: the d-shift kernel over the descending-pair
        # layout — both wedge endpoints are contiguous slices (zero
        # decode gathers, no pair_cum/sample transfers), one bucket
        # probe per lane, ~2 lanes/wedge
        wide_dev, seed = eh
        if "perm_begin_np" not in prep:
            prep["perm_begin_np"] = np.asarray(
                ctx.dag_begin).astype(np.int64)
        pending = _count_shift_region(
            ctx.dag_dst, ctx.dag_begin, wide_dev, seed,
            prep["perm_begin_np"], 0, ctx.num_dag_edges, chunk)
        return limb_fetch_sum(pending)
    subs = list(_wedge_subranges(ctx))
    hints = _class_pad_hints(subs, chunk, max_deg,
                             int(ctx.dag_dst.shape[0]))
    # defer all fetches to the end: every slice's pair_cum/samples
    # transfer and dispatch submission overlap device compute; ONE
    # batched counter fetch closes the run
    pending = []
    for (lo, sub, samples, span_bits, pc_base), hint in zip(subs,
                                                            hints):
        pending += _count_sub(sub.dag_begin, sub.dag_dst, sub.pair_cum,
                              jnp.asarray(samples), sub.num_wedges,
                              chunk, bits, span_bits,
                              samples_np=samples, max_deg=max_deg,
                              pc_base=pc_base,
                              pad_hint=hint, defer=True)
    return limb_fetch_sum(pending)


def _permuted_ctx(ctx: DagContext) -> DagContext:
    """DagContext over the descending-pair row layout (hashed-membership
    counting only: ``dag_begin`` here indexes ROW POSITIONS, not ranks,
    so the binary-search fallback must never see this context)."""
    dag_begin = np.asarray(ctx.dag_begin)
    dag_dst = np.asarray(ctx.dag_dst)
    D = ctx.num_dag_edges
    perm_dst, cum, nb = descending_row_layout(dag_begin, dag_dst, D)
    d_pad = int(dag_dst.shape[0])
    n = dag_begin.shape[0] - 1
    out_dst = np.full(d_pad, n, np.int32)
    out_dst[:D] = perm_dst
    pc = np.zeros(d_pad + 1, np.int64)
    pc[: cum.shape[0]] = cum
    if cum.shape[0] < d_pad + 1:
        pc[cum.shape[0]:] = cum[-1]
    return DagContext(
        dag_begin=jnp.asarray(np.minimum(nb, 2**31 - 1)
                              .astype(np.int32)),
        dag_dst=jnp.asarray(out_dst),
        pair_cum=jnp.asarray(np.minimum(pc, 2**31 - 1).astype(np.int32)),
        num_wedges=ctx.num_wedges,
        num_dag_edges=D,
    )


def _class_pad_hints(subs, chunk: int, max_deg: int, dd_len: int):
    """Per-slice (pc_len, samples_len, s_max) pad/window targets,
    GROUPED BY WINDOW CLASS: slices sharing a quantized anchor-window
    size share one compiled kernel.  A global-maximum hint would
    compile ONE kernel but force every slice onto the worst slice's
    window (LJ: 10/11 slices need s_max=16384, the sparse tail needs
    524288).  Per-class hints pay one compile per class (LJ: 3) and
    keep each slice at its own window.  Returns a list of hints aligned
    with ``subs``."""
    chunk_eff = min(chunk, _DISPATCH_W)
    while _DISPATCH_W % chunk_eff:
        chunk_eff //= 2
    qws = []
    for lo, sub, samples, span_bits, pc_base in subs:
        qw = _quantized_windows(np.asarray(samples), sub.num_wedges,
                                chunk_eff, max_deg, dd_len)
        qws.append(qw[0] if qw is not None else 0)
    by_cls: dict = {}
    for i, (lo, sub, samples, span_bits, pc_base) in enumerate(subs):
        pc_h = 1 << max(int(sub.pair_cum.shape[0]) - 1, 1).bit_length()
        smp_h = 1 << max(int(samples.shape[0]) - 1, 1).bit_length()
        c = by_cls.setdefault(qws[i], [1, 1])
        c[0] = max(c[0], pc_h)
        c[1] = max(c[1], smp_h)
    return [(by_cls[q][0], by_cls[q][1], max(q, 1)) for q in qws]


def _count_sub(db, dd, pc, samples, num_wedges: int, chunk: int,
               bits: int, span_bits: int, samples_np=None,
               max_deg=None, pc_base: int = 0,
               pad_hint=None, defer: bool = False):
    """Drive the fixed-window SEARCH kernels over one (sub)range: many
    short dispatches, one compile.  When the host-side samples and max
    degree are supplied and the slot windows are chunk-bounded, the
    expansion decode replaces the per-wedge window search (~2x fewer
    random HBM gathers).  (Hashed-membership counting lives in the
    d-shift kernel, ``_count_wedges_shift``.)

    ``defer=True`` returns the list of un-fetched device limb counters
    instead of blocking per dispatch — callers issue the NEXT slice's
    transfers/dispatches before fetching, so host->device pc/samples
    shipping and dispatch latency overlap device compute
    (fetch with ``limb_value`` later)."""
    chunk = min(chunk, _DISPATCH_W)
    while _DISPATCH_W % chunk:
        chunk //= 2
    nl = jnp.asarray(num_wedges, jnp.int32)
    pb = jnp.asarray(pc_base, jnp.int32)
    span_bits = -(-span_bits // 4) * 4      # quantize: share compiles
    hint = tuple(pad_hint) + (1, 1, 0) if pad_hint is not None \
        else (1, 1, 0)
    pc_hint, smp_hint, sm_hint = hint[0], hint[1], hint[2]
    expand = None
    if samples_np is not None and max_deg is not None:
        expand = _quantized_windows(np.asarray(samples_np), num_wedges,
                                    chunk, int(max_deg),
                                    int(dd.shape[0]), sm_hint)
        if expand is not None:
            s_max = expand[0]
            if pc.shape[0] < s_max + 8:
                pc = jnp.concatenate([
                    pc, jnp.full((s_max + 8 - pc.shape[0],),
                                 num_wedges, pc.dtype)])
    # pad the per-slice arrays to uniform (power-of-two, or the caller's
    # global-maximum hint) lengths ON DEVICE: WITHOUT this, every
    # sub-range ships differently-shaped pair_cum/samples and forces a
    # fresh compile per slice.  The pad is jnp.full on device, so
    # transfer stays the true slice size.

    def pad_to(a, fill, hint):
        n = int(a.shape[0])
        m = max(1 << max(n - 1, 1).bit_length(), hint)
        if m > n:
            a = jnp.concatenate([a, jnp.full((m - n,), fill, a.dtype)])
        return a

    samples = pad_to(samples, samples[-1], smp_hint)
    pc = pad_to(pc, jnp.asarray(num_wedges, pc.dtype), pc_hint)
    pending = []
    for k0 in range(0, num_wedges, _DISPATCH_W):
        if expand is not None:
            t = _count_wedges_expand(
                db, dd, pc, samples, jnp.asarray(k0, jnp.int32), nl,
                pb, chunk, bits, expand[0], expand[1])
        else:
            t = _count_wedges(db, dd, pc, samples,
                              jnp.asarray(k0, jnp.int32), nl, pb,
                              chunk, bits, span_bits)
        pending.append(t)
    if defer:
        return pending
    return sum(limb_value(t) for t in pending)


# int32-safe wedge ids per device dispatch; module-level so tests can
# shrink it to exercise the sub-range splitting at small scale
_SUBRANGE_LIMIT = 2 ** 31 - (1 << 22)


def _wedge_subranges(ctx: DagContext):
    """Split the wedge id space into int32-safe sub-ranges by slicing
    the anchor-slot axis (pair_cum is monotone, so a slot range maps to
    a contiguous wedge range; re-basing pair_cum keeps ids < 2^31)."""
    LIMIT = _SUBRANGE_LIMIT
    if ctx.num_wedges < LIMIT:
        cum32 = np.asarray(ctx.pair_cum).astype(np.int64)
        smp, sb = _anchor_samples(cum32, ctx.num_wedges)
        yield 0, ctx, smp, sb, 0
        return
    pair_cum = np.asarray(ctx.pair_cum).astype(np.int64)
    # pair_cum was clipped at int32 max when overflowing; rebuild exact
    # 64-bit prefix from the DAG host-side
    dag_begin = np.asarray(ctx.dag_begin).astype(np.int64)
    D = ctx.num_dag_edges
    dag_dst = np.asarray(ctx.dag_dst)
    deg = np.diff(dag_begin)
    src = np.repeat(np.arange(dag_begin.shape[0] - 1, dtype=np.int64),
                    deg)
    row_end = dag_begin[src + 1]
    slots = np.arange(D, dtype=np.int64)
    pairs = row_end - slots - 1
    cum = np.zeros(D + 1, np.int64)
    cum[1:] = np.cumsum(pairs)
    s0 = 0
    while s0 < D:
        # largest s1 with cum[s1] - cum[s0] < LIMIT (anchor-slot axis;
        # target slots j stay global, so dag_dst is shared untouched).
        # pair_cum ships as the [s0 .. s1+1] SLICE plus its base offset
        # — per-slice transfer is O(D/slices), not O(D)
        s1 = int(np.searchsorted(cum, cum[s0] + LIMIT, side="left"))
        s1 = max(min(s1 - 1, D), s0 + 1)
        n_w = int(cum[s1] - cum[s0])
        pcv = np.clip(cum[s0: s1 + 2] - cum[s0], 0, n_w)
        sub = DagContext(
            dag_begin=ctx.dag_begin, dag_dst=ctx.dag_dst,
            pair_cum=jnp.asarray(pcv.astype(np.int32)),
            num_wedges=n_w, num_dag_edges=s1)
        smp, sb = _anchor_samples(pcv, n_w)
        smp = (smp.astype(np.int64) + s0).astype(np.int32)
        yield int(cum[s0]), sub, smp, sb, s0
        s0 = s1


def triangle_count_np(begin, node_idx):
    """Host oracle: literal transliteration of triangle_counting.gm."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    rows = [set(node_idx[begin[v]:begin[v + 1]].tolist()) for v in range(N)]
    T = 0
    for v in range(N):
        nbrs = sorted(rows[v])
        for u in nbrs:
            if u <= v:
                continue
            for w in nbrs:
                if w <= u:
                    continue
                if u in rows[w]:
                    T += 1
    return T


# ---------------------------------------------------------------------------
# Literal semantics (directed graphs, multigraph slot counting)
# ---------------------------------------------------------------------------

class LiteralCtx(NamedTuple):
    f_dst: jax.Array       # [F_pad] suffix-slot dst values (sorted per row)
    jbase: jax.Array       # [F_pad] first strictly-greater pair slot
    pair_cum: jax.Array    # [F_pad+1]
    num_wedges: int
    cum64: np.ndarray      # [F_pad+1] exact 64-bit wedge prefix (host)


def build_literal(g: Graph) -> LiteralCtx:
    """Host-side wedge schedule for the literal ``triangle_counting.gm``
    semantics: ``Foreach(u: v.Nbrs)(u > v) Foreach(w: v.Nbrs)(w > u)``
    iterates CSR *slots* with strict value ordering, so parallel edges
    multiply wedge counts exactly as the generated OpenMP loops do
    (``gm_cpp_gen_foreach.cc:33-328``)."""
    begin = np.asarray(g.begin)
    dst = np.asarray(g.node_idx)[: g.num_edges].astype(np.int64)
    N = g.num_nodes
    deg = np.diff(begin).astype(np.int64)
    src = np.repeat(np.arange(N, dtype=np.int64), deg)

    keep = dst > src                     # suffix of each semi-sorted row
    f_dst_np = dst[keep]
    f_src = src[keep]
    f_cnt = np.bincount(f_src, minlength=N).astype(np.int64)
    f_begin = np.zeros(N + 1, np.int64)
    np.cumsum(f_cnt, out=f_begin[1:])
    F = int(f_dst_np.shape[0])

    # strictly-greater pair base: skip the tail of the current equal run
    slots = np.arange(F, dtype=np.int64)
    row_end = f_begin[f_src + 1]
    # run ends: position of last slot with the same (row, value)
    if F:
        same_next = np.zeros(F, bool)
        same_next[:-1] = (f_dst_np[1:] == f_dst_np[:-1]) & \
            (f_src[1:] == f_src[:-1])
        # eq_after[i] = number of following slots in the same equal run
        run_end = np.empty(F, np.int64)
        idx = F - 1
        # vectorized run-end: positions where run breaks
        brk = np.nonzero(~same_next)[0]          # last slot of each run
        run_id = np.zeros(F, np.int64)
        run_id[1:] = (~same_next[:-1]).cumsum()
        run_end = brk[run_id]
        jbase_np = run_end + 1
    else:
        jbase_np = np.zeros(0, np.int64)
    pairs = np.maximum(row_end - jbase_np, 0)

    f_pad = round_up(max(F, 1))
    pair_cum = np.zeros(f_pad + 1, np.int64)
    pair_cum[1:F + 1] = np.cumsum(pairs)
    if F < f_pad:
        pair_cum[F + 1:] = pair_cum[F] if F else 0
    f_dst_pad = np.full(f_pad, N, np.int64)
    f_dst_pad[:F] = f_dst_np
    jbase_pad = np.zeros(f_pad, np.int64)
    jbase_pad[:F] = jbase_np

    return LiteralCtx(
        f_dst=jnp.asarray(f_dst_pad.astype(np.int32)),
        jbase=jnp.asarray(jbase_pad.astype(np.int32)),
        pair_cum=jnp.asarray(np.minimum(pair_cum, 2**31 - 1)
                             .astype(np.int32)),
        num_wedges=int(pair_cum[F]) if F else 0,
        cum64=pair_cum,
    )


@partial(jax.jit, static_argnames=("num_wedges", "chunk"))
def _count_wedges_literal(g: Graph, f_dst, jbase, pair_cum,
                          num_wedges: int, chunk: int) -> jax.Array:
    """hit(k) = HasEdgeTo(w_k, u_k) over the *original* directed CSR."""
    from ..ops.segment import has_edge_to
    num_chunks = (num_wedges + chunk - 1) // chunk

    def do_chunk(ci, acc):
        k = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        valid = k < num_wedges
        kk = jnp.minimum(k, num_wedges - 1)
        i = jnp.searchsorted(pair_cum, kk, side="right") - 1
        off = kk - pair_cum[i]
        j = jbase[i] + off
        u = f_dst[i]
        w = f_dst[jnp.clip(j, 0, f_dst.shape[0] - 1)]
        uu = jnp.clip(u, 0, g.num_nodes - 1).astype(g.node_dtype)
        ww = jnp.clip(w, 0, g.num_nodes - 1).astype(g.node_dtype)
        hit = has_edge_to(g, ww, uu) & valid & (u < g.num_nodes)
        return limb_add(acc, jnp.sum(hit.astype(jnp.int32)))

    return jax.lax.fori_loop(0, num_chunks, do_chunk, limb_zero())


def triangle_count_literal(g: Graph, chunk: int = 1 << 20) -> int:
    """Exact reference semantics on arbitrary (directed, multi-) graphs —
    the CLI/parity entry point.  ``triangle_count`` (degree-oriented DAG)
    remains the fast path for symmetric simple graphs, where both agree.
    Wedge spaces beyond int32 are processed in re-based sub-ranges on
    the anchor-slot axis (pair_cum is monotone)."""
    prep = _prep_of(g)
    if "lit" not in prep:
        prep["lit"] = build_literal(g)
    ctx = prep["lit"]
    cum = ctx.cum64
    total_w = int(cum[-1])
    if total_w == 0:
        return 0
    if g.num_nodes <= _BITMAP_MAX_N and total_w <= _EXPAND_MAX_W:
        if "lit_fast" not in prep:
            n = g.num_nodes
            e = g.num_edges
            src = np.asarray(g.node_idx_src)[:e].astype(np.int64)
            dst = np.asarray(g.node_idx)[:e].astype(np.int64)
            table, W = _bitword_table(src, dst, n)
            f_dst = np.asarray(ctx.f_dst).astype(np.int64)
            jb = np.asarray(ctx.jbase).astype(np.int64)
            pairs = np.diff(cum)
            u, w_arr = _expand_pairs(f_dst, jb, pairs, f_dst)
            wp = round_up(max(u.shape[0], 1))
            uu = np.zeros(wp, np.int32)
            ww = np.zeros(wp, np.int32)
            vv = np.zeros(wp, bool)
            uu[: u.shape[0]] = u
            ww[: w_arr.shape[0]] = w_arr
            vv[: u.shape[0]] = True
            prep["lit_fast"] = (table, W, jnp.asarray(uu),
                                jnp.asarray(ww), jnp.asarray(vv))
        table, W, uu, ww, vv = prep["lit_fast"]
        # hit = HasEdgeTo(w, u): edge (w -> u) in the original CSR
        return int(_count_expanded(table, ww, uu, vv, W))
    total = 0
    idx = np.arange(cum.shape[0], dtype=np.int64)
    LIMIT = _SUBRANGE_LIMIT
    s0 = 0
    F1 = cum.shape[0] - 1
    while cum[s0] < total_w:
        s1 = int(np.searchsorted(cum, cum[s0] + LIMIT, side="left"))
        s1 = max(min(s1 - 1, F1), s0 + 1)
        n_w = int(cum[s1] - cum[s0])
        if n_w == 0:
            break
        pcv = np.clip(cum[np.minimum(idx, s1)] - cum[s0], 0, n_w)
        chunk_s = min(chunk, round_up(n_w))
        t = _count_wedges_literal(g, ctx.f_dst, ctx.jbase,
                                  jnp.asarray(pcv.astype(np.int32)),
                                  n_w, chunk_s)
        total += limb_value(t)
        s0 = s1
    return total
