"""chip_smoke.py off the card: it must refuse to run, and its parity
helpers and phase selection must be right on tiny arrays."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_on_cpu():
    res = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs NVIDIA GPUs" in res.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_close_uses_relative_error_with_floor_one():
    assert cs.close([1.0, 2.0002], [1.0, 2.0]) == pytest.approx(1e-4)
    assert cs.close([1e-3 + 1e-4], [1e-3]) == pytest.approx(1e-4)


def test_compare_summaries():
    want = [["q0", "1", "2", "3", "4", "C1", "0.5", "-1.5", "C2", "0.6", "-1"]]
    got = [list(want[0])]
    got[0][6] = "0.50005"
    assert cs.compare_summaries(got, want) == pytest.approx(5e-5)
    got[0][5], got[0][8] = "C2", "C1"
    with pytest.raises(cs.SmokeFailure, match="nearest classes"):
        cs.compare_summaries(got, want)
    with pytest.raises(cs.SmokeFailure, match="line counts"):
        cs.compare_summaries(got, want * 2)


def test_ca_errors_align_signs():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((6, 12))
    flipped = c * np.where(np.arange(12) % 2, -1.0, 1.0)
    inertia = np.linspace(0.3, 0.01, 12)
    assert cs.ca_errors(flipped, inertia, c, inertia) == (0.0, 0.0)
    in_err, c_err = cs.ca_errors(c + 1e-3, inertia * (1 + 1e-7), c, inertia)
    assert c_err == pytest.approx(1e-3)
    assert in_err == pytest.approx(1e-7)


@pytest.mark.parametrize("argv,phases", [
    ([], ["ca", "serve", "relate", "kernel"]),
    (["--four"], ["four"]),
])
def test_phase_selection(argv, phases, monkeypatch, capsys):
    import jax

    ran = []
    monkeypatch.setattr(cs, "start", lambda n: jax)
    monkeypatch.setattr(cs, "build_corpus", lambda seed, work: ("p", None, []))
    monkeypatch.setattr(cs, "phase_ca",
                        lambda *a: ran.append("ca") or "tw")
    for name in ("serve", "relate", "kernel", "four"):
        monkeypatch.setattr(cs, "phase_" + name,
                            lambda *a, _n=name: ran.append(_n))
    assert cs.main(argv) == 0
    assert ran == phases
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
