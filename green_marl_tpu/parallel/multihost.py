"""Multi-host runtime bootstrap (the XOMP analog).

The reference's only true multi-node execution path is Barrelfish XOMP:
``common_main.h:100-150`` replicates the OpenMP runtime across
non-coherent domains before the algorithm runs.  The equivalent here is
the JAX distributed runtime: every process calls :func:`init` before any
computation, after which ``jax.devices()`` spans all processes, a
:class:`~jax.sharding.Mesh` built over the global device list runs its
collectives through NCCL (over NVLink between the GPUs of one host), and
the vertex-sharded engine (``parallel.vertex_sharded``) runs unchanged —
its ``all_to_all`` ghost exchange and ``psum`` master scalars become
cross-process collectives.

On CPU (CI / this image), collectives go through gloo
(``jax_cpu_collectives_implementation``), so the multi-host path is
*executed* in tests with real separate processes — coverage the
reference never had for its distributed backends (compile-only,
``test/regression/test.py:157-158``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids: Optional[Sequence[int]] = None,
         local_cpu_devices: int = 0) -> None:
    """Initialize the distributed runtime (call before any jax use).

    ``local_cpu_devices > 0`` forces that many virtual CPU devices per
    process first (CI / development without accelerators).  Nothing
    detects a cluster on its own: pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` explicitly, and
    on a GPU host give each process its own cards through
    ``local_device_ids``.
    """
    if local_cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_cpu_devices}").strip()
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    if local_cpu_devices:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)


def global_mesh(axis: str = "v"):
    """1-D mesh over every device of every process."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_rows_to_mesh(arrs, mesh, axis: str = "v"):
    """Build global device arrays for [S, ...] row-sharded numpy inputs
    in a multi-process world: each process materializes only the rows
    its local devices own (``jax.make_array_from_callback``)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = []
    for a in arrs:
        a = np.asarray(a)
        spec = P(axis, *([None] * (a.ndim - 1)))
        sharding = NamedSharding(mesh, spec)
        arr = jax.make_array_from_callback(
            a.shape, sharding, lambda idx, a=a: a[idx])
        out.append(arr)
    return out


def place_multihost(vsg, mesh, axis: str = "v"):
    """Multi-process variant of ``vertex_sharded.place``: every process
    holds the full host-side build (deterministic) and materializes its
    local shards only."""
    import dataclasses
    fields = ("dst_local", "src_vidx", "emask", "csc_slot", "send_idx",
              "deg_owned")
    arrs = shard_rows_to_mesh([getattr(vsg, f) for f in fields], mesh,
                              axis)
    return dataclasses.replace(vsg, **dict(zip(fields, arrs)))
