"""Mesh-scaling regression: the sharded CA and the kmer-sharded serving
must not slow down pathologically as the mesh grows (the collective payload
is O(B x d), independent of the sharded axis).  A CPU statistic of
benchmarks/scaling.py, not a device metric."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_child(n_dev: int) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    env["KPOP_SCALING_SCALE"] = "0.5"
    res = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "benchmarks", "scaling.py"),
            "--child",
            str(n_dev),
        ],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr[-1500:]
    line = next(
        l for l in res.stdout.splitlines() if l.startswith("{")
    )
    return json.loads(line)


def _best_of(n_dev: int, runs: int = 3) -> dict:
    """Min over repeated child runs: wall times on a shared CI host are
    contention-noisy; the minimum is the stable contention-free estimate.
    The kmer-vs-dp ratio is computed PER CHILD first (both sides from the
    same process — the contention-invariance the gate relies on), then
    minned; minning the two walls independently would mix children."""
    results = [_run_child(n_dev) for _ in range(runs)]
    for r in results:
        if "serving_dp_warm_s_per_batch" in r:
            r["serving_vs_dp"] = (
                r["serving_warm_s_per_batch"]
                / r["serving_dp_warm_s_per_batch"]
            )
    best = dict(results[0])
    for r in results[1:]:
        for key in best:
            if isinstance(best[key], float):
                best[key] = min(best[key], r[key])
    return best


def test_no_pathological_slowdown_at_8_devices():
    """What this gates is the SHARDING overhead, not the host's thread
    contention (8 virtual devices on 2 physical cores make absolute
    1-dev-vs-8-dev ratios contention-dominated and machine-dependent):

    - serving: the kmer-sharded {data:4, kmer:2} mesh vs the pure
      data-parallel {data:8} mesh AT THE SAME DEVICE COUNT, measured in
      the same child process — identical contention on both sides, so the
      ratio isolates the psum/collective cost of kmer-sharding.  Measured
      ~0.8x (kmer-sharding is faster: smaller per-device vocab); a
      pathological collective regression would push it well past 1.2x.
    - CA: the Gram-psum path's 8-device wall vs 1 device; the collective
      payload is O(cols^2), tiny, so even on 2 shared cores the measured
      ratio is ~1.1x.  1.5x flags a real dispatch/collective regression.
    """
    one = _best_of(1)
    eight = _best_of(8)
    assert eight["mesh"] == {"data": 4, "kmer": 2}
    assert eight["ca_warm_s"] <= 1.5 * one["ca_warm_s"], (one, eight)
    assert eight["serving_vs_dp"] <= 1.2, eight
