"""Global configuration for kpop-tpu.

Precision policy
----------------
The reference computes everything in float64 on CPU (OCaml floats).  The
device paths run their large kernels (counting, projection, distances, CA
Gram matrix) in float32 by default (``compute_dtype()``), with every f32
matmul pinned to ``Precision.HIGHEST`` so no path silently drops to TF32;
small, precision-critical reductions (the CA eigendecomposition of the
[n_samples, n_samples] Gram matrix, summary statistics) run in float64 on
the host via numpy.  Setting ``KPOP_X64=1`` before importing JAX opts into
full float64 JAX computation (CPU parity testing).

JAX is imported lazily (via :func:`jax_setup`) so that the pure-numpy CLI
paths do not pay JAX/XLA startup cost.

Environment variables
---------------------
KPOP_X64=1                 enable jax_enable_x64 and float64 compute dtype.
KPOP_DENSE_K_MAX           max k for the dense 4^k counting path (default 13).
JAX_PLATFORMS              the JAX platform (tests use ``cpu``).
JAX_COMPILATION_CACHE_DIR  persistent compile cache; when unset the cache
                           is ``<checkout>/.jax_cache`` (:data:`CACHE_DIR`).
"""

from __future__ import annotations

import os

X64 = os.environ.get("KPOP_X64", "0") not in ("", "0", "false", "False")

#: maximum k for which the dense 4^k counting path is used (4^13 = 67M
#: int32 = 268 MB on the device; beyond that the host sparse path takes over)
DENSE_K_MAX = int(os.environ.get("KPOP_DENSE_K_MAX", "13"))

#: default persistent compile cache: a fixed path inside the checkout (the
#: path is part of the cache key, so it must not move between runs)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_configured = False


def jax_setup():
    """Import and configure JAX on first use; returns the jax module."""
    global _configured
    import jax

    if not _configured:
        if X64:
            jax.config.update("jax_enable_x64", True)
        # JAX reads JAX_COMPILATION_CACHE_DIR itself; only without it does
        # the program name a cache
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _configured = True
    return jax


def compute_dtype():
    import jax.numpy as jnp

    return jnp.float64 if X64 else jnp.float32
