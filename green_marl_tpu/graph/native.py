"""ctypes bindings for the native host runtime (``native/gm_io.cc``).

The reference's graph runtime is C++ (``apps/output_cpp/gm_graph``); here
the device compute path is JAX but the host-side heavy lifting —
CSR/CSC freeze with semi-sort and reverse edges, edge-list text parsing,
RMAT generation — has a native OpenMP implementation, auto-built on first
use (``make -C native``) with a transparent numpy fallback when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_BUILD_ERROR: Optional[str] = None

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _BUILD_ERROR
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libgmtpu_io.so")
    src = os.path.join(_NATIVE_DIR, "gm_io.cc")
    stale = (not os.path.exists(so)
             or (os.path.exists(src)
                 and os.path.getmtime(so) < os.path.getmtime(src)))
    if stale:
        # rebuild on source-newer-than-binary too: a stale .so with
        # changed semantics (e.g. the hash empty-sentinel value) would
        # poison versioned on-disk caches built through it
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "-B"],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            err = getattr(e, "stderr", None) or b""
            _BUILD_ERROR = (f"{type(e).__name__}: "
                            f"{err.decode(errors='replace')[-400:] or e}")
            if not os.path.exists(so):
                return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        _BUILD_ERROR = f"load failed: {e}"
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gm_build_csr.restype = ctypes.c_int
    lib.gm_build_csr.argtypes = [i32p, i32p, ctypes.c_int64,
                                 ctypes.c_int32] + [i32p] * 8
    lib.gm_parse_edge_list.restype = ctypes.c_int64
    lib.gm_parse_edge_list.argtypes = [ctypes.c_char_p, i32p, i32p,
                                       ctypes.c_int64, ctypes.c_int32]
    lib.gm_rmat_edges.restype = None
    lib.gm_rmat_edges.argtypes = [
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, i32p, i32p]
    try:
        lib.gm_xorshift_lengths.restype = None
        lib.gm_xorshift_lengths.argtypes = [ctypes.c_int64,
                                            ctypes.c_int32,
                                            ctypes.c_int32, i32p]
    except AttributeError:   # stale .so without the symbol
        pass
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the last build or load of the library failed (None if it
    did not)."""
    _load()
    return _BUILD_ERROR


def openmp() -> Optional[bool]:
    """Whether the loaded library was built with OpenMP (the Makefile
    falls back to a serial build without it); None if none loaded."""
    fn = getattr(_load(), "gm_openmp", None)   # absent from a stale .so
    return None if fn is None else bool(fn())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """Native CSR+CSC build; returns the 8 arrays of ``csr.from_edges``'s
    core or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    e = src.shape[0]
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    begin = np.empty(n + 1, np.int32)
    csr_dst = np.empty(e, np.int32)
    csr_src = np.empty(e, np.int32)
    csr_perm = np.empty(e, np.int32)
    r_begin = np.empty(n + 1, np.int32)
    csc_src = np.empty(e, np.int32)
    csc_dst = np.empty(e, np.int32)
    e_rev2idx = np.empty(e, np.int32)
    rc = lib.gm_build_csr(_ptr(src), _ptr(dst), e, n, _ptr(begin),
                          _ptr(csr_dst), _ptr(csr_src), _ptr(csr_perm),
                          _ptr(r_begin), _ptr(csc_src), _ptr(csc_dst),
                          _ptr(e_rev2idx))
    if rc != 0:
        raise ValueError("edge endpoint out of range")
    return (begin, csr_dst, csr_src, csr_perm, r_begin, csc_src,
            csc_dst, e_rev2idx)


def parse_edge_list(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    n = lib.gm_parse_edge_list(path.encode(), None, None, 0, 1)
    if n < 0:
        raise ValueError(f"cannot parse {path}")
    src = np.empty(n, np.int32)
    dst = np.empty(n, np.int32)
    n2 = lib.gm_parse_edge_list(path.encode(), _ptr(src), _ptr(dst), n, 0)
    assert n2 == n
    return src, dst


def rmat_edges(n: int, m: int, seed: int = 0, a: float = 0.45,
               b: float = 0.22, c: float = 0.22,
               permute: bool = True
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parallel native RMAT (~20x the numpy generator's speed).  Stream
    differs from the numpy generator; both are deterministic per seed."""
    lib = _load()
    if lib is None:
        return None
    src = np.empty(m, np.int32)
    dst = np.empty(m, np.int32)
    lib.gm_rmat_edges(n, m, seed, a, b, c, int(permute), _ptr(src),
                      _ptr(dst))
    return src, dst


def xorshift_lengths(n: int, mod: int = 100, add: int = 1):
    """Reference gm_rand32 sequence natively ((rand()%mod)+add per CSR
    slot, sssp_main.cc:31-33); None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gm_xorshift_lengths"):
        return None
    out = np.empty(n, np.int32)
    lib.gm_xorshift_lengths(n, mod, add, _ptr(out))
    return out


def _bind_tri(lib):
    import ctypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    if getattr(lib, "_tri_bound", False):
        return True
    try:
        lib.gm_build_dag.restype = ctypes.c_int64
        lib.gm_build_dag.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                     i32p]
        lib.gm_hash_fill.restype = ctypes.c_int64
        lib.gm_hash_fill.argtypes = [i32p, i32p, ctypes.c_int32,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_uint32,
                                     i32p, i32p]
        lib.gm_desc_layout.restype = None
        lib.gm_desc_layout.argtypes = [i32p, i32p, ctypes.c_int32,
                                       i32p, i32p]
        lib.gm_hash_fill_wide.restype = ctypes.c_int64
        lib.gm_hash_fill_wide.argtypes = [i32p, i32p, ctypes.c_int32,
                                          ctypes.c_int64,
                                          ctypes.c_int64,
                                          ctypes.c_int32,
                                          ctypes.c_uint32, i32p]
    except AttributeError:          # stale .so
        return False
    lib._tri_bound = True
    return True


def build_dag(begin: np.ndarray, dst: np.ndarray, n: int):
    """Degree-rank DAG orientation from an undirected CSR (native).
    Returns (dag_begin[n+1] int32, dag_dst[:D] int32) or None."""
    lib = _load()
    if lib is None or not _bind_tri(lib):
        return None
    begin = np.ascontiguousarray(begin, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    dag_begin = np.empty(n + 1, np.int32)
    dag_dst = np.empty(max(dst.shape[0], 1), np.int32)
    d = lib.gm_build_dag(_ptr(begin), _ptr(dst), n, _ptr(dag_begin),
                         _ptr(dag_dst))
    if d < 0:
        return None
    return dag_begin, dag_dst[:d]


def hash_fill(dag_begin: np.ndarray, dag_dst: np.ndarray, n: int,
              d: int, hp: int, hs: int, seed: int):
    """Two-level bucketed hash fill (native).  Returns
    (prim [hp,16], sec [hs,32], fail_count) or None."""
    lib = _load()
    if lib is None or not _bind_tri(lib):
        return None
    dag_begin = np.ascontiguousarray(dag_begin, np.int32)
    dag_dst = np.ascontiguousarray(dag_dst, np.int32)
    prim = np.empty((hp, 16), np.int32)
    sec = np.empty((hs, 32), np.int32)
    fail = lib.gm_hash_fill(_ptr(dag_begin), _ptr(dag_dst), n, d, hp,
                            hs, np.uint32(seed), _ptr(prim), _ptr(sec))
    return prim, sec, int(fail)


def hash_fill_wide(dag_begin: np.ndarray, dag_dst: np.ndarray, n: int,
                   d: int, hw: int, slots: int, seed: int):
    """One-level wide bucketed hash fill (native): ``slots`` (b, c)
    pairs per bucket, one bucket = one contiguous ``2*slots``-int32
    row.  Returns (wide [hw, 2*slots], fail_count) or None."""
    lib = _load()
    if lib is None or not _bind_tri(lib):
        return None
    dag_begin = np.ascontiguousarray(dag_begin, np.int32)
    dag_dst = np.ascontiguousarray(dag_dst, np.int32)
    wide = np.empty((hw, 2 * slots), np.int32)
    fail = lib.gm_hash_fill_wide(_ptr(dag_begin), _ptr(dag_dst), n, d,
                                 hw, slots, np.uint32(seed), _ptr(wide))
    return wide, int(fail)


def desc_layout(dag_begin: np.ndarray, dag_dst: np.ndarray, n: int,
                d: int):
    """Descending-pair row layout (native).  Returns
    (perm_dst[:d], nb[n+1] int32) or None."""
    lib = _load()
    if lib is None or not _bind_tri(lib):
        return None
    dag_begin = np.ascontiguousarray(dag_begin, np.int32)
    dag_dst = np.ascontiguousarray(dag_dst, np.int32)
    perm_dst = np.empty(max(d, 1), np.int32)
    nb = np.empty(n + 1, np.int32)
    lib.gm_desc_layout(_ptr(dag_begin), _ptr(dag_dst), n,
                       _ptr(perm_dst), _ptr(nb))
    return perm_dst[:d], nb
