"""Device timing utilities.

JAX dispatch is asynchronous, so every timed region here ends in
``jax.block_until_ready`` on the result.
"""

from __future__ import annotations

import time
from typing import Callable, List

import jax
import numpy as np


def device_times(fn: Callable, *args, reps: int = 5,
                 warmup: int = 1) -> List[float]:
    """Wall seconds of each of ``reps`` calls of ``fn(*args)``, each
    synced with ``jax.block_until_ready``, after ``warmup`` untimed
    calls (compile)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def profile_supersteps(step, state, cond, max_iter: int = 10 ** 6,
                       out=None):
    """Host-driven superstep loop with per-step device timing — the
    reference's Shoal step timers / BFS ``PROFILE_LEVEL_TIME`` analog
    (``gm_cpp_gen.cc:761-770``, ``gm_bfs_template.h:85-96``).

    ``step(state) -> state``; ``cond(state) -> bool-ish device scalar``.
    Each step is synced with ``jax.block_until_ready``; lines print as
    ``superstep[i] time=X ms`` (parseable by the extract pipeline).
    Returns the final state.  Slower than the fused ``lax.while_loop``
    (one dispatch per step) — profiling mode only.
    """
    import sys
    i = 0
    while i < max_iter and bool(np.asarray(jax.device_get(cond(state)))):
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state))
        dt = (time.perf_counter() - t0) * 1000
        print(f"superstep[{i}] time={dt:.3f} ms",
              file=out or sys.stdout, flush=True)
        i += 1
    return state


def graph_placement_report(g, extra=()) -> str:
    """Per-array HBM placement table for a device-resident Graph — the
    runtime's ``Array[...]`` report lines (Shoal, run.sh:218-236) plus
    the compiler's decision table (gm_cpp_gen.cc:229-305)."""
    rows = []
    fields = ["begin", "node_idx", "node_idx_src", "r_begin",
              "r_node_idx", "r_node_idx_dst", "e_rev2idx"]
    for f in fields:
        a = getattr(g, f)
        rows.append(
            f"Array[{f}]: elements={a.size} size={a.nbytes} "
            f"dtype={a.dtype} -- hugepage=[ ] replication=[X] "
            f"distribution=[ ]")
    for name, a in extra:
        rows.append(
            f"Array[{name}]: elements={a.size} size={a.nbytes} "
            f"dtype={a.dtype} -- hugepage=[ ] replication=[X] "
            f"distribution=[ ]")
    return "\n".join(rows)
