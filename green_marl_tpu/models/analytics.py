"""Small analytic procedures: avg_teen_cnt, adamicAdar, potential_friends,
triangle_counting_directed.

Each docstring cites the ``.gm`` source it reimplements.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops import scan_reduce
from ..ops import segment as ops


@jax.jit
def avg_teen_cnt(g: Graph, age: jax.Array, k) -> tuple:
    """``apps/src/avg_teen_cnt.gm``: teen_cnt[n] = #in-nbrs with age in
    [10, 20); return Avg over nodes with age > K of teen_cnt (0 if no such
    node, matching Avg over an empty set = 0 in the reference runtime)."""
    teen = (age >= 10) & (age < 20)
    cnt = scan_reduce.in_nbr_count_true(g, teen)
    sel = (age > k) & g.node_mask()
    num = jnp.sum(jnp.where(sel, cnt, 0)).astype(jnp.float32)
    den = jnp.sum(sel.astype(jnp.int32)).astype(jnp.float32)
    return jnp.where(den > 0, num / den, 0.0), cnt


def adamic_adar_edges(g: Graph, chunk: int = 1 << 16) -> np.ndarray:
    """Host wrapper computing the static pair-space size, then running the
    chunked device kernel.  Returns [E] float32 in CSR slot order."""
    begin = np.asarray(g.begin)
    deg = np.diff(begin)
    src = np.asarray(g.node_idx_src)[: g.num_edges]
    pair_cnt = deg[src]
    cum = np.zeros(g.num_edges + 1, np.int64)
    np.cumsum(pair_cnt, out=cum[1:])
    total = int(cum[-1])
    if total == 0:
        return np.zeros(g.num_edges, np.float32)
    aa = _adamic_adar_device(g, jnp.asarray(cum), total, chunk)
    return np.asarray(aa)[: g.num_edges]


@partial(jax.jit, static_argnames=("total", "chunk"))
def _adamic_adar_device(g: Graph, cum: jax.Array, total: int,
                        chunk: int) -> jax.Array:
    degf = jnp.pad(g.begin[1:] - g.begin[:-1],
                   (0, g.n_pad - g.num_nodes)).astype(jnp.float32)
    w = 1.0 / jnp.log(jnp.maximum(degf, 1.0000001))
    n_chunks = -(-total // chunk)

    def do_chunk(ci, acc):
        k = ci * chunk + jnp.arange(chunk)
        valid = k < total
        kk = jnp.minimum(k, total - 1)
        e = jnp.searchsorted(cum, kk, side="right") - 1   # CSR slot
        off = kk - cum[e]
        frm = g.node_idx_src[e]
        to = g.node_idx[e]
        j = g.begin[frm] + off                            # candidate slot
        n = g.node_idx[jnp.clip(j, 0, g.e_pad - 1)]       # candidate nbr
        hit = ops.has_edge_to(g, to, n) & valid & (n < g.num_nodes)
        contrib = jnp.where(hit, w[jnp.clip(n, 0, g.n_pad - 1)], 0.0)
        return acc.at[e].add(jnp.where(valid, contrib, 0.0))

    acc0 = jnp.zeros((g.e_pad,), jnp.float32)
    return jax.lax.fori_loop(0, n_chunks, do_chunk, acc0)


@partial(jax.jit, static_argnames=())
def potential_friends(g: Graph) -> jax.Array:
    """``apps/src/potential_friends.gm``: per node v, the set of 2-hop
    neighbors w (w in N(u), u in N(v), w != u != v) with no direct edge
    v->w.  Returns a dense [N_pad, N_pad] bool membership matrix (the
    reference returns per-node bitmap ``gm_sized_set``s, i.e. the same
    O(N^2) bits); intended for moderate N — one matrix product counts
    the 2-hop paths (0/1 operands: exact even at TF32 precision).
    """
    n_pad = g.n_pad
    mask = g.node_mask()
    # dense adjacency (bool): A[v, u] = edge v->u
    a = jnp.zeros((n_pad, n_pad), jnp.float32)
    a = a.at[g.node_idx_src, g.node_idx].set(1.0)
    a = a * mask[:, None] * mask[None, :]
    two_hop = (a @ a) > 0
    eye = jnp.eye(n_pad, dtype=bool)
    pot = two_hop & (a == 0) & ~eye
    return pot & mask[:, None] & mask[None, :]


def triangle_directed_count(g: Graph, chunk: int = 1 << 16) -> int:
    """``apps/src/triangle_counting_directed.gm``: Foreach v, ordered
    out-nbr pairs (u, w) with w > u; count if edge u->w or w->u exists.

    Same chunked wedge enumeration as the undirected counter but over the
    raw (unoriented) CSR and testing both directions.
    """
    begin = np.asarray(g.begin)
    deg = np.diff(begin).astype(np.int64)
    pairs = deg * (deg - 1) // 2
    cum = np.zeros(g.num_nodes + 1, np.int64)
    np.cumsum(pairs, out=cum[1:])
    total = int(cum[-1])
    if total == 0:
        return 0
    return int(_triangle_directed_device(
        g, jnp.asarray(cum), total, min(chunk, 1 << 20)))


@partial(jax.jit, static_argnames=("total", "chunk"))
def _triangle_directed_device(g: Graph, cum: jax.Array, total: int,
                              chunk: int) -> jax.Array:
    n_chunks = -(-total // chunk)

    def pair_from_flat(v, off):
        """off-th ordered pair (i, j), i<j, within a row of length d.

        Triangular numbering: pairs anchored at slot i start at
        base(i) = i*(2d-i-1)/2.  Inverted by integer binary search (exact;
        valid while C(d,2) fits int32, i.e. row degree < 65536).
        """
        d = (g.begin[v + 1] - g.begin[v]).astype(jnp.int32)
        off = off.astype(jnp.int32)

        def base(i):
            return i * (2 * d - i - 1) // 2

        lo = jnp.zeros_like(d)
        hi = jnp.maximum(d - 2, 0)

        def body(_, st):
            lo, hi = st
            mid = (lo + hi + 1) // 2
            go = base(mid) <= off
            return jnp.where(go, mid, lo), jnp.where(go, hi, mid - 1)

        lo, hi = jax.lax.fori_loop(0, 18, body, (lo, hi))
        i = lo
        j = i + 1 + (off - base(i))
        return i, j

    def do_chunk(ci, acc):
        k = ci * chunk + jnp.arange(chunk)
        valid = k < total
        kk = jnp.minimum(k, total - 1)
        v = (jnp.searchsorted(cum, kk, side="right") - 1).astype(jnp.int32)
        off = kk - cum[v]
        i, j = pair_from_flat(v, off)
        lo = g.begin[v]
        u = g.node_idx[jnp.clip(lo + i, 0, g.e_pad - 1)]
        ww = g.node_idx[jnp.clip(lo + j, 0, g.e_pad - 1)]
        # reference predicate: (w > u); rows are dst-sorted so j>i implies
        # ww >= u; equal (multi-edge) pairs excluded by strict >
        ok = valid & (ww > u)
        hit = ok & (ops.has_edge_to(g, u, ww) | ops.has_edge_to(g, ww, u))
        return acc + jnp.sum(hit.astype(jnp.int64))

    return jax.lax.fori_loop(0, n_chunks, do_chunk,
                             jnp.zeros((), jnp.int64))
