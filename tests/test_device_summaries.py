"""Device-batched summarization must match the host float64 path:
identical structure/targets/ties; numeric fields to float32 tolerance."""

import io

import numpy as np
import pytest

from kpop_tpu.core.matrix import NamedMatrix
from kpop_tpu.core.space import Distance, summarize_rowwise
from kpop_tpu.ops.summaries import summarize_rowwise_device


def make_case(rng, N=20, B=37, D=9):
    targets = NamedMatrix(
        [f"t{i}" for i in range(N)],
        [f"d{j}" for j in range(D)],
        rng.standard_normal((N, D)),
    )
    queries = NamedMatrix(
        [f"q{i}" for i in range(B)],
        [f"d{j}" for j in range(D)],
        rng.standard_normal((B, D)),
    )
    metric = rng.random(D)
    metric /= metric.sum()
    return targets, queries, metric


@pytest.mark.parametrize("spec", ["euclidean", "cosine", "minkowski(3)"])
@pytest.mark.parametrize("keep", [2, 5, None])
def test_device_summaries_match_host(spec, keep):
    rng = np.random.default_rng(0)
    targets, queries, metric = make_case(rng)
    dist = Distance.of_string(spec)
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=keep)
    buf = io.StringIO()
    n = summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=keep, normalize=True,
        out=buf, batch=8,
    )
    got = buf.getvalue().splitlines()
    assert n == len(want) == len(got)
    for g, w in zip(got, want):
        pg, pw = g.split("\t"), w.split("\t")
        assert len(pg) == len(pw), (g, w)
        assert pg[0] == pw[0]
        # same targets in the same order
        assert pg[5::3] == pw[5::3], (g, w)
        for a, b in zip(pg[1:], pw[1:]):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                continue
            assert abs(fa - fb) < 2e-4 * max(1.0, abs(fb)), (g, w)


def test_device_summaries_tie_groups():
    """A large tie group (duplicated targets) must extend the list exactly
    like the host path, via host fallback when it exceeds the slack."""
    rng = np.random.default_rng(1)
    D = 4
    base = rng.standard_normal((1, D))
    # 17 identical targets (beyond TOPK_SLACK above req_len) + 3 distinct
    targets_data = np.concatenate(
        [np.repeat(base, 17, axis=0), rng.standard_normal((3, D))], axis=0
    )
    targets = NamedMatrix(
        [f"t{i}" for i in range(20)], [f"d{j}" for j in range(D)], targets_data
    )
    queries = NamedMatrix(
        ["q0"], [f"d{j}" for j in range(D)], rng.standard_normal((1, D))
    )
    metric = np.full(D, 0.25)
    dist = Distance.of_string("euclidean")
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=2)
    buf = io.StringIO()
    summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=2, normalize=True, out=buf
    )
    got = buf.getvalue().splitlines()
    assert len(got[0].split("\t")) == len(want[0].split("\t"))
    assert got[0].split("\t")[5::3] == want[0].split("\t")[5::3]


def test_twistdb_summary_backend_jax_cli(tmp_path):
    import os
    import subprocess

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(2)
    import io as _io

    from kpop_tpu.core.counter_db import CounterDB
    from kpop_tpu.core.count import spectrum_of_sequences
    from kpop_tpu.core.kmers import KmerSpace

    space = KmerSpace("DNA-ds", 5)
    db = CounterDB()
    for c in range(6):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 300)])
        codes, counts = spectrum_of_sequences(space, [seq])
        db.add_spectra_stream(_io.StringIO(
            "\tS%d\n" % c + "".join(
                "%s\t%d\n" % (space.code_to_hex(cd), ct)
                for cd, ct in zip(codes, counts))))
    db.to_binary(str(tmp_path / "DB"))
    env = dict(os.environ, PATH=os.path.join(REPO, "bin") + os.pathsep
               + os.environ["PATH"], PYTHONPATH=REPO, JAX_PLATFORMS="cpu")

    def sh(cmd):
        res = subprocess.run(["bash", "-c", cmd], cwd=str(tmp_path), env=env,
                             capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-1500:]

    sh("kpop-twist -i DB -o TW")
    sh("kpop-twistdb -i T TW -i t TW -s TW HOST")
    sh("kpop-twistdb -i T TW -i t TW --backend jax -s TW DEV")
    host = (tmp_path / "HOST.KPopSummary.txt").read_text().splitlines()
    dev = (tmp_path / "DEV.KPopSummary.txt").read_text().splitlines()
    assert len(host) == len(dev) == 6
    for h, d in zip(host, dev):
        hp, dp = h.split("\t"), d.split("\t")
        assert hp[0] == dp[0] and hp[5::3] == dp[5::3]


@pytest.mark.parametrize("normalize", [True, False])
def test_distance_rowwise_device_matches_host(normalize):
    from kpop_tpu.core.space import distance_rowwise
    from kpop_tpu.ops.summaries import distance_rowwise_device

    rng = np.random.default_rng(4)
    targets, queries, metric = make_case(rng, N=13, B=29, D=6)
    dist = Distance.of_string("euclidean")
    want = distance_rowwise(dist, metric, targets, queries, normalize=normalize)
    got = distance_rowwise_device(
        dist, metric, targets, queries, normalize=normalize, batch=11,
    )
    assert got.row_names == want.row_names
    assert got.col_names == want.col_names
    np.testing.assert_allclose(
        np.asarray(got.data), np.asarray(want.data), rtol=2e-5, atol=2e-6
    )


def test_minkowski_blocked_broadcast_matches(monkeypatch):
    """The minkowski device digest blocks its [B, chunk, D] broadcast over
    targets; forcing a tiny element budget (multiple chunks incl. a ragged
    tail) must not change any output line."""
    import kpop_tpu.ops.summaries as summaries_mod

    rng = np.random.default_rng(3)
    targets, queries, metric = make_case(rng, N=23, B=9, D=7)
    dist = Distance.of_string("minkowski(3)")

    def run():
        buf = io.StringIO()
        summarize_rowwise_device(
            dist, metric, targets, queries, keep_at_most=3, normalize=True,
            out=buf, batch=16,
        )
        return buf.getvalue()

    full = run()
    # 9 queries x 7 dims -> chunk = 256//63 = 4 targets/chunk (6 chunks)
    monkeypatch.setattr(summaries_mod, "MINK_BUDGET_ELEMS", 256)
    summaries_mod._digest_batch.clear_cache()
    blocked = run()
    summaries_mod._digest_batch.clear_cache()
    assert blocked == full


@pytest.mark.parametrize("N", [1, 2, 3, 16, 17, 100, 101])
def test_mad_window_selection_matches_second_sort(N):
    """The digest's sort-free MAD (min over length-(N//2+1) windows of the
    sorted row containing the median index) must be bit-identical to the
    definitional second sort, including heavy ties and odd/even N."""
    import jax.numpy as jnp

    from kpop_tpu.ops import summaries as summaries_mod

    rng = np.random.default_rng(N)
    rows = [
        rng.standard_normal(N).astype(np.float32),
        rng.integers(0, 3, N).astype(np.float32),  # heavy ties
        np.zeros(N, np.float32),
        np.sort(rng.standard_normal(N).astype(np.float32)),
    ]
    for row in rows:
        srt = jnp.sort(jnp.asarray(row))[None, :]
        h = N // 2
        median = srt[:, h]
        W = min(h, N - 1 - h) + 1
        lo_diff = median[:, None] - srt[:, :W]
        hi_diff = srt[:, h : h + W] - median[:, None]
        got = np.asarray(jnp.maximum(lo_diff, hi_diff).min(axis=1))[0]
        want = np.sort(np.abs(row - np.asarray(median)[0]))[h]
        assert got == want, (N, row[:8], got, want)


def test_native_summary_formatter_byte_identical(monkeypatch):
    """The C summary-line formatter must emit byte-identical output to the
    Python %-formatting branch on the same digests — including tie groups,
    zero-variance rows (nan/inf z-scores), and non-ASCII names."""
    import kpop_tpu.ops.summaries as summaries_mod

    if not summaries_mod._native_formatter():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    D = 6
    data = rng.standard_normal((30, D))
    data[10:15] = data[10]  # a 5-way tie group
    targets = NamedMatrix(
        ["té%d" % i for i in range(30)],
        [f"d{j}" for j in range(D)],
        data,
    )
    qdata = np.concatenate(
        [rng.standard_normal((6, D)), data[10:11]], axis=0
    )  # last query coincides with the tie group (distance 0 entries)
    queries = NamedMatrix(
        ["qø%d" % i for i in range(7)], [f"d{j}" for j in range(D)], qdata
    )
    metric = np.full(D, 1.0 / D)
    dist = Distance.of_string("euclidean")

    def run():
        buf = io.StringIO()
        summarize_rowwise_device(
            dist, metric, targets, queries, keep_at_most=3, normalize=True,
            out=buf, batch=4,
        )
        return buf.getvalue()

    native_out = run()
    monkeypatch.setattr(summaries_mod, "_native_formatter", lambda: False)
    python_out = run()
    assert native_out == python_out

    # degenerate single identical target: std = 0 -> nan/inf z fields
    t1 = NamedMatrix(["t0", "t1"], [f"d{j}" for j in range(D)],
                     np.zeros((2, D)))
    q1 = NamedMatrix(["q0"], [f"d{j}" for j in range(D)],
                     np.ones((1, D)))

    def run1():
        buf = io.StringIO()
        summarize_rowwise_device(
            dist, metric, t1, q1, keep_at_most=2, normalize=True, out=buf,
        )
        return buf.getvalue()

    monkeypatch.undo()
    n1 = run1()
    monkeypatch.setattr(summaries_mod, "_native_formatter", lambda: False)
    p1 = run1()
    assert n1 == p1


def test_fallback_interleave_with_vertical_tab_names():
    """Batches mixing tie-overflow host-fallback rows with native-formatted
    rows must stay row-aligned even when names contain characters that
    str.splitlines (but not the C formatter) treats as line boundaries."""
    rng = np.random.default_rng(9)
    D = 4
    base = rng.standard_normal((1, D))
    targets_data = np.concatenate(
        [np.repeat(base, 17, axis=0), rng.standard_normal((3, D))], axis=0
    )
    targets = NamedMatrix(
        ["t\x0b%d" % i for i in range(20)],
        [f"d{j}" for j in range(D)],
        targets_data,
    )
    qdata = np.concatenate(
        [base + 0.01, rng.standard_normal((2, D)), base + 0.01], axis=0
    )
    queries = NamedMatrix(
        ["q\x0b%d" % i for i in range(4)], [f"d{j}" for j in range(D)], qdata
    )
    metric = np.full(D, 0.25)
    dist = Distance.of_string("euclidean")
    buf = io.StringIO()
    n = summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=2, normalize=True,
        out=buf, batch=4,
    )
    assert n == 4
    lines = buf.getvalue().split("\n")[:-1]
    assert len(lines) == 4
    for i, ln in enumerate(lines):
        assert ln.split("\t")[0] == "q\x0b%d" % i, ln[:40]
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=2)
    for g, w in zip(lines, want):
        assert g.split("\t")[5::3] == w.split("\t")[5::3], (g, w)
