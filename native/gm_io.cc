// Native host runtime: fast graph construction & IO.
//
// Counterpart of the reference's C++ runtime host paths:
// gm_graph::freeze/do_semi_sort/make_reverse_edges/prepare_edge_source
// (apps/output_cpp/gm_graph/src/gm_graph.cc:68-468) and the text
// edge-list reader (gm_edge_list_graph_reader.cc).  The Python layer
// binds via ctypes (no pybind11 in this image); every function is a
// flat C ABI over caller-allocated buffers.
//
// Build: see native/Makefile (g++ -O3 -fopenmp -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// 1 when built with OpenMP, 0 for the serial fallback build.
int gm_openmp() {
#if defined(_OPENMP)
  return 1;
#else
  return 0;
#endif
}

// Counting-sort based CSR+CSC build (the freeze() hot path).
// Inputs: src[e], dst[e] (int32), n nodes.
// Outputs (caller-allocated):
//   begin[n+1], csr_dst[e], csr_src[e], csr_perm[e]   (CSR, rows sorted
//     by destination — semi-sorted like the reference's do_semi_sort)
//   r_begin[n+1], csc_src[e], csc_dst[e], e_rev2idx[e] (CSC)
// Returns 0 on success.
int gm_build_csr(const int32_t* src, const int32_t* dst, int64_t e,
                 int32_t n,
                 int32_t* begin, int32_t* csr_dst, int32_t* csr_src,
                 int32_t* csr_perm,
                 int32_t* r_begin, int32_t* csc_src, int32_t* csc_dst,
                 int32_t* e_rev2idx) {
  std::vector<int64_t> cnt(static_cast<size_t>(n) + 1, 0);

  // --- CSR: counting sort by src --------------------------------------
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -1;
    cnt[src[i]]++;
  }
  int64_t run = 0;
  for (int32_t v = 0; v <= n; ++v) {
    int64_t c = (v < n) ? cnt[v] : 0;
    begin[v] = static_cast<int32_t>(run);
    cnt[v] = run;
    run += c;
  }
  std::vector<int32_t> pos(static_cast<size_t>(e));
  for (int64_t i = 0; i < e; ++i) {
    int64_t p = cnt[src[i]]++;
    csr_dst[p] = dst[i];
    csr_src[p] = src[i];
    pos[p] = static_cast<int32_t>(i);
  }
  // semi-sort: order each row by destination (stable w.r.t. input order
  // for equal destinations, matching a lexsort by (src, dst))
#pragma omp parallel for schedule(dynamic, 1024)
  for (int32_t v = 0; v < n; ++v) {
    int32_t lo = begin[v], hi = begin[v + 1];
    if (hi - lo < 2) continue;
    std::vector<int64_t> tmp(hi - lo);
    for (int32_t k = lo; k < hi; ++k)
      tmp[k - lo] = (static_cast<int64_t>(csr_dst[k]) << 32) | pos[k];
    std::sort(tmp.begin(), tmp.end());
    for (int32_t k = lo; k < hi; ++k) {
      csr_dst[k] = static_cast<int32_t>(tmp[k - lo] >> 32);
      pos[k] = static_cast<int32_t>(tmp[k - lo] & 0xFFFFFFFF);
    }
  }
  for (int64_t k = 0; k < e; ++k) csr_perm[k] = pos[k];

  // input index -> CSR slot
  std::vector<int32_t> inp2csr(static_cast<size_t>(e));
  for (int64_t k = 0; k < e; ++k) inp2csr[pos[k]] = static_cast<int32_t>(k);

  // --- CSC: counting sort by dst (then src for determinism) -----------
  std::fill(cnt.begin(), cnt.end(), 0);
  for (int64_t i = 0; i < e; ++i) cnt[dst[i]]++;
  run = 0;
  for (int32_t v = 0; v <= n; ++v) {
    int64_t c = (v < n) ? cnt[v] : 0;
    r_begin[v] = static_cast<int32_t>(run);
    cnt[v] = run;
    run += c;
  }
  // iterate edges in CSR order (already sorted by (src, dst)) so each
  // CSC row comes out sorted by src
  for (int64_t k = 0; k < e; ++k) {
    int32_t d = csr_dst[k];
    int64_t p = cnt[d]++;
    csc_src[p] = csr_src[k];
    csc_dst[p] = d;
    e_rev2idx[p] = static_cast<int32_t>(k);
  }
  return 0;
}

// Fast two/three-column text edge-list parser (SNAP style, '#' comments).
// Pass 1 (count_only=1): returns edge count. Pass 2: fills src/dst.
// Returns number of edges, or -1 on error.
int64_t gm_parse_edge_list(const char* path, int32_t* src, int32_t* dst,
                           int64_t cap, int32_t count_only) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(malloc(sz + 1));
  if (!buf) { fclose(f); return -1; }
  if (fread(buf, 1, sz, f) != static_cast<size_t>(sz)) {
    free(buf); fclose(f); return -1;
  }
  buf[sz] = 0;
  fclose(f);

  int64_t count = 0;
  char* p = buf;
  char* end = buf + sz;
  while (p < end) {
    // skip whitespace/newlines
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' ||
                       *p == '\n')) p++;
    if (p >= end) break;
    if (*p == '#') {  // comment line
      while (p < end && *p != '\n') p++;
      continue;
    }
    char* q;
    long a = strtol(p, &q, 10);
    if (q == p) { free(buf); return -1; }
    p = q;
    while (p < end && (*p == ' ' || *p == '\t')) p++;
    long b = strtol(p, &q, 10);
    if (q == p) { free(buf); return -1; }
    p = q;
    while (p < end && *p != '\n') p++;  // ignore extra columns
    if (!count_only) {
      if (count >= cap) { free(buf); return -1; }
      src[count] = static_cast<int32_t>(a);
      dst[count] = static_cast<int32_t>(b);
    }
    count++;
  }
  free(buf);
  return count;
}

// RMAT edge generator (graph_gen.cc:154-265 semantics: per-level 10%
// perturbation, self-loop rejection), xorshift RNG, parallel over edges.
void gm_rmat_edges(int32_t n, int64_t m, uint64_t seed, double a,
                   double b, double c, int32_t permute,
                   int32_t* src, int32_t* dst) {
  int scale = 0;
  while ((1 << (scale + 1)) <= n) scale++;

#pragma omp parallel
  {
#if defined(_OPENMP)
    int tid = omp_get_thread_num();
    int nth = omp_get_num_threads();
#else
    int tid = 0, nth = 1;
#endif
    uint64_t s = seed * 6364136223846793005ULL + tid * 1442695040888963407ULL
                 + 1;
    auto rnd = [&]() -> double {
      s ^= s << 13; s ^= s >> 7; s ^= s << 17;
      return (s >> 11) * (1.0 / 9007199254740992.0);
    };
    int64_t lo = m * tid / nth, hi = m * (tid + 1) / nth;
    for (int64_t i = lo; i < hi; ++i) {
      int32_t u, v;
      do {
        u = 0; v = 0;
        double av = a, bv = b, cv = c, dv = 1.0 - a - b - c;
        int32_t step = n / 2;
        for (int l = 0; l < scale; ++l) {
          if (l > 0) {
            av *= 0.95 + 0.1 * rnd();
            bv *= 0.95 + 0.1 * rnd();
            cv *= 0.95 + 0.1 * rnd();
            dv *= 0.95 + 0.1 * rnd();
            double S = av + bv + cv + dv;
            av /= S; bv /= S; cv /= S; dv /= S;
          }
          double pr = rnd();
          if (pr < av) {
          } else if (pr < av + bv) {
            v += step;
          } else if (pr < av + bv + cv) {
            u += step;
          } else {
            u += step; v += step;
          }
          step /= 2;
        }
      } while (u == v);
      src[i] = u;
      dst[i] = v;
    }
  }
  if (permute) {
    // Fisher-Yates with the same xorshift stream (host-side, serial)
    std::vector<int32_t> P(n);
    for (int32_t i = 0; i < n; ++i) P[i] = i;
    uint64_t s = seed ^ 0x9E3779B97F4A7C15ULL;
    for (int32_t i = n - 1; i > 0; --i) {
      s ^= s << 13; s ^= s >> 7; s ^= s << 17;
      int32_t j = static_cast<int32_t>(s % (static_cast<uint64_t>(i) + 1));
      std::swap(P[i], P[j]);
    }
#pragma omp parallel for
    for (int64_t i = 0; i < m; ++i) {
      src[i] = P[src[i]];
      dst[i] = P[dst[i]];
    }
  }
}
}  // extern "C"

extern "C" {
// Reference gm_rand32 sequence (sssp_main.cc weight generation):
// next ^= next<<13; next = next>>17 (arithmetic); next ^= next<<5.
// Sequential recurrence — generated natively so LJ-scale runs don't
// pay a per-element Python loop.
void gm_xorshift_lengths(int64_t n, int32_t mod, int32_t add,
                         int32_t* out) {
  int32_t next = (int32_t)2463534242u;
  for (int64_t i = 0; i < n; ++i) {
    next ^= (int32_t)((uint32_t)next << 13);
    next = next >> 17;
    next ^= (int32_t)((uint32_t)next << 5);
    int32_t v = next;
    if (mod > 0) v = (int32_t)(v % mod) + add;
    out[i] = v;
  }
}
}


// ---------------------------------------------------------------------------
// Triangle preprocessing (round-5): degree-rank DAG orientation, the
// bucketed edge-hash fill, and the descending-pair row layout — native
// versions of models/triangle.py's build_dag / build_edge_hash /
// descending_row_layout (the numpy versions remain the fallback).
// Reference analog: the one-time prepare()-phase index builds in
// gm_graph.cc:205-468 (reverse edges, semi-sort).
// ---------------------------------------------------------------------------

extern "C" {

// Degree-ordered DAG from an UNDIRECTED CSR (rows semi-sorted by value,
// duplicates allowed — deduped here).  Outputs rows indexed by RANK
// (ascending degree, ties by id), row values = destination ranks,
// sorted.  Returns D (kept edges) or -1 on bad input.
int64_t gm_build_dag(const int32_t* begin, const int32_t* dst, int32_t n,
                     int32_t* dag_begin, int32_t* dag_dst) {
  std::vector<int32_t> order(n);
  for (int32_t v = 0; v < n; ++v) order[v] = v;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    int32_t da = begin[a + 1] - begin[a], db = begin[b + 1] - begin[b];
    return da != db ? da < db : a < b;
  });
  std::vector<int32_t> rank(n);
  for (int32_t r = 0; r < n; ++r) rank[order[r]] = r;

  // pass 1: kept-edge count per rank row (dedup consecutive values —
  // rows are semi-sorted)
  std::vector<int64_t> cnt(static_cast<size_t>(n) + 1, 0);
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t v = 0; v < n; ++v) {
    int32_t rv = rank[v];
    int64_t c = 0;
    int32_t prev = -1;
    for (int32_t k = begin[v]; k < begin[v + 1]; ++k) {
      int32_t u = dst[k];
      if (u == prev) continue;
      prev = u;
      if (u < 0 || u >= n) continue;
      if (rank[u] > rv) ++c;
    }
    cnt[rv] = c;
  }
  int64_t run = 0;
  for (int32_t r = 0; r <= n; ++r) {
    int64_t c = (r < n) ? cnt[r] : 0;
    dag_begin[r] = static_cast<int32_t>(run);
    cnt[r] = run;
    run += c;
  }
  // pass 2: fill + sort each rank row
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t v = 0; v < n; ++v) {
    int32_t rv = rank[v];
    int64_t w = cnt[rv];
    int32_t prev = -1;
    for (int32_t k = begin[v]; k < begin[v + 1]; ++k) {
      int32_t u = dst[k];
      if (u == prev) continue;
      prev = u;
      if (u < 0 || u >= n) continue;
      if (rank[u] > rv) dag_dst[w++] = rank[u];
    }
    std::sort(dag_dst + cnt[rv], dag_dst + w);
  }
  return run;
}

// Bucketed two-level hash fill of the D dag edges (rank_src, rank_dst).
// prim: [hp * 16] int32 (8 slots x (b, c)), sec: [hs * 32] (16 slots).
// Deterministic (slot-order insertion, matching the numpy stable fill).
// Returns number of keys that fit NOWHERE (0 = success).
static inline uint32_t gm_mix_(uint32_t b, uint32_t c, uint32_t seed) {
  uint32_t u = b * 0x9E3779B1u ^ c * 0x85EBCA77u ^ seed;
  u ^= u >> 16;
  u *= 0xC2B2AE35u;
  u ^= u >> 13;
  return u;
}

int64_t gm_hash_fill(const int32_t* dag_begin, const int32_t* dag_dst,
                     int32_t n, int64_t d, int64_t hp, int64_t hs,
                     uint32_t seed, int32_t* prim, int32_t* sec) {
  std::fill(prim, prim + hp * 16, -1);
  std::fill(sec, sec + hs * 32, -1);
  std::vector<int32_t> h1(static_cast<size_t>(d));
  std::vector<int32_t> bsrc(static_cast<size_t>(d));
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < n; ++r) {
    for (int32_t k = dag_begin[r]; k < dag_begin[r + 1]; ++k) {
      bsrc[k] = r;
      h1[k] = static_cast<int32_t>(
          gm_mix_(static_cast<uint32_t>(r),
                  static_cast<uint32_t>(dag_dst[k]), seed) %
          static_cast<uint32_t>(hp));
    }
  }
  std::vector<int8_t> pcnt(static_cast<size_t>(hp), 0);
  std::vector<int64_t> over;
  for (int64_t k = 0; k < d; ++k) {
    int64_t b = h1[k];
    if (pcnt[b] < 8) {
      int64_t slot = b * 16 + pcnt[b] * 2;
      prim[slot] = bsrc[k];
      prim[slot + 1] = dag_dst[k];
      pcnt[b]++;
    } else {
      over.push_back(k);
    }
  }
  std::vector<int8_t> scnt(static_cast<size_t>(hs), 0);
  int64_t fail = 0;
  uint32_t seed2 = seed ^ 0x5bd1e995u;
  for (int64_t k : over) {
    int64_t b = gm_mix_(static_cast<uint32_t>(bsrc[k]),
                        static_cast<uint32_t>(dag_dst[k]), seed2) %
        static_cast<uint32_t>(hs);
    if (scnt[b] < 16) {
      int64_t slot = b * 32 + scnt[b] * 2;
      sec[slot] = bsrc[k];
      sec[slot + 1] = dag_dst[k];
      scnt[b]++;
    } else {
      ++fail;
    }
  }
  return fail;
}

// Descending-pair row layout: rows reordered by pairs = deg*(deg-1)/2
// descending (stable), rows copied contiguously.  nb[n+1] = permuted
// row offsets; perm_dst[d] = permuted destination ranks.
void gm_desc_layout(const int32_t* dag_begin, const int32_t* dag_dst,
                    int32_t n, int32_t* perm_dst, int32_t* nb) {
  std::vector<int32_t> order(n);
  for (int32_t v = 0; v < n; ++v) order[v] = v;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) {
    int64_t da = dag_begin[a + 1] - dag_begin[a];
    int64_t db = dag_begin[b + 1] - dag_begin[b];
    return da * (da - 1) / 2 > db * (db - 1) / 2;
  });
  std::vector<int64_t> starts(static_cast<size_t>(n) + 1, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t v = order[i];
    starts[i + 1] = starts[i] + (dag_begin[v + 1] - dag_begin[v]);
  }
  for (int32_t v = 0; v <= n; ++v) nb[v] = static_cast<int32_t>(starts[v]);
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t i = 0; i < n; ++i) {
    int32_t v = order[i];
    std::memcpy(perm_dst + starts[i], dag_dst + dag_begin[v],
                sizeof(int32_t) *
                    (dag_begin[v + 1] - dag_begin[v]));
  }
}

// One-level WIDE bucketed hash fill: wide is [hw * 2*slots] int32 —
// `slots` (b, c) key pairs per bucket, one bucket = one contiguous
// row.  With slots=64 a bucket is 512 B, one contiguous row gathered
// per probe.  Deterministic slot-order insertion, matching the numpy
// stable fill.  Returns the
// number of keys that did not fit (0 = success; caller retries seeds).
int64_t gm_hash_fill_wide(const int32_t* dag_begin,
                          const int32_t* dag_dst, int32_t n, int64_t d,
                          int64_t hw, int32_t slots, uint32_t seed,
                          int32_t* wide) {
  // empty sentinel 0xFFFFFF (not -1, matching triangle._H_EMPTY):
  // pair (E, E) has b == c, unreachable by b < c queries
  std::fill(wide, wide + hw * 2 * slots, 0xFFFFFF);
  std::vector<int32_t> h1(static_cast<size_t>(d));
  std::vector<int32_t> bsrc(static_cast<size_t>(d));
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < n; ++r) {
    for (int32_t k = dag_begin[r]; k < dag_begin[r + 1]; ++k) {
      bsrc[k] = r;
      h1[k] = static_cast<int32_t>(
          gm_mix_(static_cast<uint32_t>(r),
                  static_cast<uint32_t>(dag_dst[k]), seed) %
          static_cast<uint32_t>(hw));
    }
  }
  std::vector<int16_t> cnt(static_cast<size_t>(hw), 0);
  int64_t fail = 0;
  for (int64_t k = 0; k < d; ++k) {
    int64_t b = h1[k];
    if (cnt[b] < slots) {
      int64_t slot = b * 2 * slots + cnt[b] * 2;
      wide[slot] = bsrc[k];
      wide[slot + 1] = dag_dst[k];
      cnt[b]++;
    } else {
      ++fail;
    }
  }
  return fail;
}

}  // extern "C" (continued)
