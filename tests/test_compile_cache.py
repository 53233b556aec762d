"""Persistent compile cache: where it lives, and cross-process reuse.

With a deterministic backend (CPU), a second process compiling the same
serving step must HIT the cache (no new entries) rather than recompile
under a fresh key.  The cache lives where ``JAX_COMPILATION_CACHE_DIR``
says; without it, at the fixed ``<checkout>/.jax_cache``."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, %r)
    import numpy as np
    from kpop_tpu.config import jax_setup
    jax = jax_setup()
    # CPU compiles are fast; cache them anyway for this test
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp
    from kpop_tpu.ops.pipeline import (
        ClassifierParams, count_spectra, distances_to_classes, project,
        summarize_batch,
    )

    k, V, d, C, B, L = 6, 512, 32, 16, 8, 256
    rng = np.random.default_rng(0)
    lut = np.full(4**k + 1, V, dtype=np.int32)
    lut[rng.choice(4**k, size=V, replace=False)] = np.arange(
        V, dtype=np.int32
    )
    params = ClassifierParams(
        jnp.asarray(lut),
        jnp.asarray(rng.standard_normal((V, d)).astype(np.float32)),
        jnp.full((d,), 1.0 / d, jnp.float32),
        jnp.asarray(rng.standard_normal((C, d)).astype(np.float32)),
        jnp.ones((C,), jnp.float32),
        k, True,
    )

    @jax.jit
    def step(p, codes):
        dmat = distances_to_classes(p, project(p, count_spectra(p, codes)))
        return summarize_batch(dmat, 2)

    codes = jnp.asarray(rng.integers(0, 4, size=(B, L)).astype(np.int8))
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(params, codes))
    print("COMPILE_S", round(time.perf_counter() - t0, 3))
""") % (REPO,)


def _cache_files(cache_dir: str) -> set:
    out = set()
    for root, _dirs, files in os.walk(cache_dir):
        out.update(os.path.join(root, f) for f in files)
    return out


def test_persistent_cache_cross_process_hit(tmp_path):
    cache = str(tmp_path / "jax_cache")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def run_child():
        res = subprocess.run(
            [sys.executable, "-c", CHILD], env=env, capture_output=True,
            text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        assert "COMPILE_S" in res.stdout
        return res

    run_child()
    after_first = _cache_files(cache)
    assert after_first, "first process wrote no cache entries"
    run_child()
    after_second = _cache_files(cache)
    new = after_second - after_first
    assert not new, (
        "second process MISSED the persistent cache (unstable keys or "
        f"cache not consulted): new entries {sorted(new)[:5]}"
    )


PROBE = (
    "import sys; sys.path.insert(0, %r)\n"
    "from kpop_tpu.config import jax_setup\n"
    "print(jax_setup().config.jax_compilation_cache_dir)\n"
) % (REPO,)


def _cache_dir_of(env: dict) -> str:
    res = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.strip().splitlines()[-1]


def test_cache_dir_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert _cache_dir_of(env) == str(tmp_path / "c")


def test_cache_dir_default_is_fixed_in_checkout():
    from kpop_tpu.config import CACHE_DIR

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir_of(env) == CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
