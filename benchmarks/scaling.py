#!/usr/bin/env python3
"""Sharding overhead of the sharded CA and the kmer-sharded serving on a
virtual CPU mesh (1/2/4/8 devices): a CPU statistic, not a device metric.

Virtual devices (xla_force_host_platform_device_count) share the host's
physical cores, so the curve cannot show speedup; what it shows is that the
sharded paths (Gram psum, kmer-partitioned serving psum) add no
pathological overhead as the mesh grows: collective cost per batch is
O(B x d), independent of the sharded axis.

Each device count runs in its own subprocess (the device count must be set
before JAX backend init).  Prints the result as one JSON line.

Usage:  python -m benchmarks.scaling           # full 1/2/4/8 curve
        python benchmarks/scaling.py --child N # (internal)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# fixed workload: identical across device counts (weak scaling would grow
# it; a shared-CPU mesh makes constant-work the honest choice).  The
# KPOP_SCALING_SCALE env var shrinks everything for the CI regression test.
_S = float(os.environ.get("KPOP_SCALING_SCALE", "1"))
CA_ROWS, CA_COLS = int(200_000 * _S), 48
V, D, C, B, L = int(120_000 * _S), 256, 256, 64, int(10_000 * _S)


def _child(n_dev: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_dev}"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np

    from kpop_tpu.config import jax_setup

    jax = jax_setup()
    import jax.numpy as jnp

    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS, make_mesh
    from kpop_tpu.parallel.sharded import ca_fit_sharded
    from kpop_tpu.parallel.serving import (
        shard_classifier_params,
        sharded_dmat_fn,
    )
    from kpop_tpu.ops.pipeline import ClassifierParams

    assert jax.device_count() == n_dev, jax.device_count()
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(0)

    # ---- sharded CA (dd + compact wire), warm ----
    table = rng.integers(0, 40, size=(CA_ROWS, CA_COLS)).astype(np.int32)
    ca_fit_sharded(mesh, table)  # compile + first run
    ca_s = float("inf")  # min over reps: shared-host walls are noisy
    for _ in range(3):
        t0 = time.perf_counter()
        coords, inertia, _tw, _sv = ca_fit_sharded(mesh, table)
        ca_s = min(ca_s, time.perf_counter() - t0)

    # ---- kmer-sharded serving, warm ----
    k = 10
    codes_space = 4**k
    vocab_codes = rng.choice(codes_space, size=V, replace=False)
    lut = np.full(codes_space + 1, V, dtype=np.int32)
    lut[vocab_codes] = np.arange(V, dtype=np.int32)
    params = ClassifierParams(
        vocab_lut=jnp.asarray(lut),
        twister=jnp.asarray(
            rng.standard_normal((V, D)).astype(np.float32)
        ),
        metric=jnp.full((D,), 1.0 / D, jnp.float32),
        class_coords=jnp.asarray(
            rng.standard_normal((C, D)).astype(np.float32)
        ),
        class_norms=jnp.ones((C,), jnp.float32),
        k=k,
        canonical=True,
    )
    batch = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    bd = jnp.asarray(batch)
    def _serve_warm(mesh_):
        sharded_, v_glob_ = shard_classifier_params(params, mesh_)
        fn_ = sharded_dmat_fn(mesh_, v_glob_)
        bd_ = bd
        pad_ = (-bd.shape[0]) % mesh_.shape[DATA_AXIS]
        if pad_:
            bd_ = jnp.concatenate(
                [bd, jnp.full((pad_, L), -1, jnp.int8)]
            )
        jax.block_until_ready(fn_(sharded_, bd_))  # compile + first run
        best = float("inf")
        for _ in range(3):  # min of three 3-batch reps
            t0 = time.perf_counter()
            for _ in range(3):
                out = fn_(sharded_, bd_)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / 3)
        return best

    serve_s = _serve_warm(mesh)
    record = {
        "n_devices": n_dev,
        "mesh": dict(mesh.shape),
        "host_cpus": os.cpu_count(),
        "ca_warm_s": round(ca_s, 3),
        "serving_warm_s_per_batch": round(serve_s, 4),
    }
    if mesh.shape[KMER_AXIS] > 1:
        # same device count, pure data-parallel mesh: identical thread
        # contention, so serving_warm / serving_dp_warm isolates the
        # kmer-sharding collective overhead from the shared-host noise
        dp_mesh = make_mesh(n_dev, data_parallel=n_dev)
        record["serving_dp_warm_s_per_batch"] = round(
            _serve_warm(dp_mesh), 4
        )
    print(json.dumps(record))


def main(device_counts=(1, 2, 4, 8), repeats=3) -> dict:
    points = []
    for n in device_counts:
        best = None
        for _ in range(repeats):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            env["PYTHONPATH"] = REPO
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--child", str(n)],
                env=env, capture_output=True, text=True, timeout=1200,
            )
            line = next(
                (l for l in res.stdout.splitlines() if l.startswith("{")),
                None,
            )
            if res.returncode != 0 or line is None:
                raise RuntimeError(
                    f"scaling child n={n} failed: {res.stderr[-1000:]}"
                )
            p = json.loads(line)
            sys.stderr.write(f"scaling: {line}\n")
            if "serving_dp_warm_s_per_batch" in p:
                # the contention-invariance claim requires both sides of
                # the ratio to come from the SAME child: keep the
                # per-child ratio, then min over repeats below
                p["serving_vs_dp"] = (
                    p["serving_warm_s_per_batch"]
                    / p["serving_dp_warm_s_per_batch"]
                )
            if best is None:
                best = p
            else:  # min over repeats: shared-host walls are noisy
                for key, val in p.items():
                    if isinstance(val, float):
                        best[key] = min(best[key], val)
        points.append(best)
    base_ca = points[0]["ca_warm_s"]
    base_sv = points[0]["serving_warm_s_per_batch"]
    result = {
        "label": "CPU-mesh RELATIVE curve (N virtual devices share "
                 "host_cpus physical cores, so the 4/8-device points pay "
                 "thread-contention overhead that real devices would not; "
                 "demonstrates BOUNDED sharding+dispatch overhead, not "
                 "multi-device speedup)",
        "host_cpus": os.cpu_count(),
        "workload": {
            "ca_table": [CA_ROWS, CA_COLS],
            "serving": {"V": V, "D": D, "C": C, "B": B, "L": L},
        },
        "points": points,
        "ca_rel_wall": [round(p["ca_warm_s"] / base_ca, 3) for p in points],
        "serving_rel_wall": [
            round(p["serving_warm_s_per_batch"] / base_sv, 3)
            for p in points
        ],
        # contention-invariant sharding-overhead ratio: kmer-sharded mesh
        # vs pure data-parallel mesh at the SAME device count, both sides
        # measured in the same child process (per-child ratio, min over
        # repeats) — <=1.0 means kmer-sharding costs nothing over
        # data-parallel at these shapes
        "serving_vs_dp_same_devices": {
            str(p["n_devices"]): round(p["serving_vs_dp"], 3)
            for p in points if "serving_vs_dp" in p
        },
    }
    return result


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        _child(int(sys.argv[2]))
    else:
        print(json.dumps(main()))
