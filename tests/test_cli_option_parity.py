"""Option-name parity with the reference help tables.

tests/data/reference_options.json is extracted from the reference sources
(the visible `Tools.Argv` alias lists in /root/reference/bin/*.ml, OCaml
comments stripped); every alias the reference documents must be accepted
by the corresponding CLI here, so reference workflow scripts are drop-in.
Extra options (documented extensions like --backend) are allowed.
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "reference_options.json")

CLIS = {
    "KPopCount": "kpop-count",
    "KPopCountDB": "kpop-countdb",
    "KPopTwist_": "kpop-twist",
    "KPopTwistDB": "kpop-twistdb",
}


def markdown_of(cli: str) -> str:
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        [cli, "--markdown"], env=env, capture_output=True, text=True
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("ref_name", sorted(CLIS))
def test_every_reference_option_is_accepted(ref_name):
    with open(FIXTURE) as f:
        table = json.load(f)[ref_name]
    md = markdown_of(CLIS[ref_name])
    # option tokens as they appear in the markdown help (inside backticks)
    documented = set(re.findall(r"`(-[^`\s]*)`", md))
    missing = [
        alias
        for aliases in table
        for alias in aliases
        if alias not in documented
    ]
    assert not missing, f"{ref_name}: undocumented aliases {missing}"


def test_splits_at_most_rejects_all_cleanly(tmp_path):
    """The reference's own help advertises 'all' but parses int-only
    (bin/KPopTwistDB.ml:241-246); we reproduce the int-only parse but turn
    int('all') into a clean ParseError instead of a traceback."""
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        ["kpop-twistdb", "--splits-at-most", "all"],
        env=env,
        capture_output=True,
        text=True,
    )
    assert res.returncode != 0
    assert "Traceback" not in res.stderr
    assert "expected an integer" in res.stderr


def test_kpop_count_accepts_threads(tmp_path):
    """-t/-T accepted (advisory no-op) so shared workflow scripts that pass
    threads to every stage keep working (ref bin/KPopCount.ml:188-194)."""
    fa = tmp_path / "r.fasta"
    fa.write_text(">s1\nACGTACGTACGT\n")
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    for opt in ("-t", "-T", "--threads"):
        res = subprocess.run(
            ["kpop-count", "-k", "3", "-L", opt, "4", "-f", str(fa)],
            env=env,
            capture_output=True,
            text=True,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        assert res.stdout.startswith("\ts1\n")


def test_splits_seed_rejects_garbage_cleanly(tmp_path):
    """--splits-seed goes through the same ParseError-wrapped int parse as
    every other numeric option (negative seeds stay legal)."""
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        ["kpop-twistdb", "--splits-seed", "abc"],
        env=env,
        capture_output=True,
        text=True,
    )
    assert res.returncode != 0
    assert "Traceback" not in res.stderr
    assert "expected an integer" in res.stderr


def test_hbm_budget_env_unparseable_falls_through(monkeypatch, capsys):
    """A typo'd KPOP_CA_HBM_BYTES must not silently DISABLE budgeting: it
    warns and falls through to the default (None on CPU meshes)."""
    import jax

    from kpop_tpu.parallel.sharded import _hbm_budget
    from jax.sharding import Mesh

    mesh = Mesh(
        __import__("numpy").array(jax.devices("cpu")[:1]), ("data",)
    )
    monkeypatch.setenv("KPOP_CA_HBM_BYTES", "8GB")
    assert _hbm_budget(mesh) is None  # CPU default, not "disabled by typo"
    assert "unparseable" in capsys.readouterr().err
    monkeypatch.setenv("KPOP_CA_HBM_BYTES", "0")
    assert _hbm_budget(mesh) is None  # explicit 0 disables, silently
    assert "unparseable" not in capsys.readouterr().err
    monkeypatch.setenv("KPOP_CA_HBM_BYTES", "123456")
    assert _hbm_budget(mesh) == 123456
