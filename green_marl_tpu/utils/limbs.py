"""Two-limb int32 counters for >2^31 device-side accumulation.

JAX runs with int64 disabled by default (jax_enable_x64 off): an
``jnp.int64`` accumulator silently truncates to int32 with a warning.
Graph-scale counters (traversed edges across thousands of instances,
triangle counts on billion-edge graphs) can exceed 2^31, so device loops
accumulate into a (hi, lo) pair of int32 limbs, lo kept in [0, 2^30):
exact up to 2^61.  Equivalent role to the reference's plain ``int64_t``
counters (e.g. triangle ``cnt`` in the generated OpenMP code).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LO_BITS = 30
_LO_MASK = (1 << _LO_BITS) - 1


def limb_zero():
    return (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))


def limb_add(acc, s):
    """Add a non-negative int32 ``s`` (< 2^30) into the accumulator."""
    hi, lo = acc
    lo = lo + s.astype(jnp.int32)
    hi = hi + (lo >> _LO_BITS)
    return hi, lo & _LO_MASK


def limb_value(acc) -> int:
    """Host-side exact value (Python int)."""
    hi, lo = acc
    return (int(jax.device_get(hi)) << _LO_BITS) + int(jax.device_get(lo))


def limb_fetch_sum(accs) -> int:
    """Exact sum of many limb accumulators with ONE device->host fetch
    (each ``limb_value`` costs two device->host fetches, and a
    triangle run has one accumulator per dispatch).  The lo limbs are summed on device
    as 15-bit halves so K <= 65536 accumulators cannot overflow
    int32."""
    if not accs:
        return 0
    his = jnp.stack([h for h, _ in accs])
    los = jnp.stack([lo for _, lo in accs])
    parts = jnp.stack([jnp.sum(his), jnp.sum(los >> 15),
                       jnp.sum(los & 0x7fff)])
    import numpy as np
    p = np.asarray(jax.device_get(parts)).astype(np.int64)
    return int((p[0] << _LO_BITS) + (p[1] << 15) + p[2])
