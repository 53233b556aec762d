"""The benchmark harness scenarios must run and hit their invariants."""

import json
import subprocess
import sys
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_harness_quickstart_and_relatedness():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.harness", "quickstart"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    )
    data = json.loads(res.stdout.strip().splitlines()[-1])
    assert data["accuracy"] == 1.0
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.harness", "relatedness"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    )
    data = json.loads(res.stdout.strip().splitlines()[-1])
    assert data["pairs"] == data["samples"] ** 2


def test_harness_device_backends():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.harness", "quickstart",
         "--backend", "jax"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    )
    data = json.loads(res.stdout.strip().splitlines()[-1])
    assert data["backend"] == "jax" and data["accuracy"] == 1.0
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.harness", "relatedness",
         "--backend", "jax"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    )
    data = json.loads(res.stdout.strip().splitlines()[-1])
    assert data["backend"] == "jax" and data["pairs"] == data["samples"] ** 2
