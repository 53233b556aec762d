"""The -v live progress layer (reference TermIO UX, lib/KMerDB.ml:226-229):
format, throttling, stderr-only output, and CLI wiring."""

import io
import os
import subprocess
import sys

import numpy as np

from kpop_tpu.utils.progress import Progress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_progress_format_and_done():
    buf = io.StringIO()
    p = Progress("F", "Doing things", 10, enabled=True, stream=buf,
                 min_interval=0.0)
    p.update(3)
    p.update(7)
    p.done()
    out = buf.getvalue()
    assert "\r\x1b[K(F): Doing things [3/10]" in out
    assert "(F): Doing things [7/10]" in out
    assert out.endswith("(F): Doing things [10/10] done.\n")


def test_progress_disabled_writes_nothing():
    buf = io.StringIO()
    p = Progress("F", "x", 10, enabled=False, stream=buf, min_interval=0.0)
    p.update(5)
    p.done()
    assert buf.getvalue() == ""


def test_progress_throttles():
    buf = io.StringIO()
    p = Progress("F", "x", None, enabled=True, stream=buf,
                 min_interval=3600.0)
    for i in range(1000):
        p.step()
    # first emit goes through; the next 999 are throttled by wall time
    assert buf.getvalue().count("\r") == 1
    p.done()
    assert buf.getvalue().count("\r") == 2  # done() forces a final line


def test_progress_survives_closed_stream():
    buf = io.StringIO()
    p = Progress("F", "x", 10, enabled=True, stream=buf, min_interval=0.0)
    p.update(1)
    buf.close()
    p.update(2)  # must not raise; reporting just stops
    p.done()


def test_cli_verbose_emits_progress_on_stderr_only(tmp_path):
    """kpop-countdb -v streams \\r progress to stderr; stdout (the piped
    data path) is byte-identical to the non-verbose run."""
    env = dict(os.environ)
    env["PATH"] = os.path.join(REPO, "bin") + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    rng = np.random.default_rng(0)
    spectra = tmp_path / "in.KPopSpectra.txt"
    with open(spectra, "w") as f:
        for s in range(6):
            f.write("\tS%d\n" % s)
            for code in rng.choice(4**6, size=500, replace=False):
                f.write("%03x\t%d\n" % (code, rng.integers(1, 30)))

    def run(*flags):
        return subprocess.run(
            ["kpop-countdb", "-k", str(tmp_path / "in"), *flags,
             "-t", "/dev/stdout"],
            env=env, capture_output=True, text=True,
        )

    plain = run()
    verbose = run("-v")
    assert plain.returncode == 0 and verbose.returncode == 0
    assert plain.stdout == verbose.stdout
    # \r is newline-translated by text=True; the clear-line escape marks
    # the carriage-return progress lines unambiguously
    assert "\x1b[K" not in plain.stderr
    assert "\x1b[K" in verbose.stderr
    assert "(KMerDB.add_files): Reading spectra" in verbose.stderr
    assert "(KMerDB.to_table): Writing table" in verbose.stderr
