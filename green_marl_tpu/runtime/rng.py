"""Runtime RNG (reference ``gm_rand``/per-thread erand48 seeds).

The reference keeps one xorshift/erand48 state per OpenMP thread
(``src/gm_runtime.cc:60-75``, ``inc/gm_rand.h``); the JAX
equivalent is JAX's counter-based threefry keys — splittable per step and
per lane, deterministic under any device count (per-thread streams are
not, which the reference accepts; we improve on it).

Helpers here cover the sampling apps' builtins: ``Uniform()``,
``G.PickRandom()``, ``n.PickRandomNbr()`` (``random_*_sampling.gm``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph.csr import Graph


def uniform(key, shape=()) -> jax.Array:
    """``Uniform()`` builtin — U[0,1) float32."""
    return jax.random.uniform(key, shape, jnp.float32)


def pick_random_nodes(key, g: Graph, shape=()) -> jax.Array:
    """``G.PickRandom()`` — uniform node ids."""
    return jax.random.randint(key, shape, 0, g.num_nodes, jnp.int32)


def pick_random_nbr(key, g: Graph, v: jax.Array) -> jax.Array:
    """``n.PickRandomNbr()`` — uniform out-neighbor of each v.

    For degree-0 nodes returns the sentinel (caller handles, as the
    reference guards with ``n.Degree() == 0``).
    """
    lo = g.begin[v]
    deg = g.begin[v + 1] - lo
    u = jax.random.uniform(key, jnp.shape(v), jnp.float32)
    off = jnp.floor(u * jnp.maximum(deg, 1).astype(jnp.float32)).astype(
        g.edge_dtype)
    off = jnp.minimum(off, jnp.maximum(deg - 1, 0))
    idx = jnp.clip(lo + off, 0, g.e_pad - 1)
    nbr = g.node_idx[idx]
    return jnp.where(deg > 0, nbr, g.sentinel)
