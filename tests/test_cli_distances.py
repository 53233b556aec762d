"""kpop-countdb --distances (raw spectral distances) and large-k sparse
counting paths."""

import io
import os
import subprocess

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")


def sh(cmd: str, cwd) -> str:
    env = dict(os.environ)
    env["PATH"] = BIN + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        ["bash", "-c", cmd], cwd=str(cwd), env=env, capture_output=True,
        text=True,
    )
    assert res.returncode == 0, f"{cmd}\n{res.stderr[-2000:]}"
    return res.stdout


def test_countdb_spectral_distances(tmp_path):
    (tmp_path / "a.fasta").write_text(
        ">x1\nACGTACGTACGTACGTAAAA\n>x2\nACGTACGTACGTACGTAAAC\n"
        ">y1\nTTTTGGGGCCCCAAAATTTT\n"
    )
    sh(
        "kpop-count -k 4 -L -f a.fasta -o /dev/stdout | "
        "kpop-countdb -k /dev/stdin "
        "--distances '~x' '~.' DM -o DB",
        tmp_path,
    )
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType

    dm = KPopMatrix.of_binary(MatrixType.DMATRIX, str(tmp_path / "DM"))
    # selection 1 = {x1, x2}; selection 2 = all three
    assert dm.matrix.col_names == ["x1", "x2"]
    assert dm.matrix.row_names == ["x1", "x2", "y1"]
    data = np.asarray(dm.matrix.data)
    assert data[0, 0] == 0.0  # x1 vs x1
    assert data[2, 0] > data[1, 0]  # y1 farther from x1 than x2 is


def test_countdb_distances_normalization_flag(tmp_path):
    (tmp_path / "a.fasta").write_text(">x\nACGTACGTTT\n")
    # x2 = the same reads counted twice: normalized spectra identical
    # -> distance ~0
    sh(
        "{ kpop-count -k 4 -l x1 -f a.fasta -o /dev/stdout; "
        "  kpop-count -k 4 -l x2 -f a.fasta -f a.fasta -o /dev/stdout; } | "
        "kpop-countdb -k /dev/stdin --distances '~x1' '~x2' DM",
        tmp_path,
    )
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType

    dm = KPopMatrix.of_binary(MatrixType.DMATRIX, str(tmp_path / "DM"))
    assert float(np.asarray(dm.matrix.data)[0, 0]) < 1e-12


def test_large_k_sparse_counting(tmp_path):
    """k=20 exceeds DENSE_K_MAX -> sparse accumulator with code merging."""
    from kpop_tpu.core.count import SpectrumAccumulator
    from kpop_tpu.core.kmers import KmerSpace, encode_dna

    space = KmerSpace("DNA-ds", 20)
    acc = SpectrumAccumulator(space)
    assert acc.dense is None
    rng = np.random.default_rng(0)
    seq1 = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 100)])
    codes1 = space.window_codes(encode_dna(seq1))
    acc.add(codes1)
    acc.add(codes1)  # same codes again: counts double via sparse merge
    codes, counts = acc.nonzero()
    want_codes, want_counts = np.unique(codes1, return_counts=True)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(counts, want_counts * 2)
    # labels are 10 hex chars (40 bits)
    assert len(space.codes_to_hex(codes[:1])[0]) == 10


def test_large_k_cli_roundtrip(tmp_path):
    (tmp_path / "g.fasta").write_text(">g\n" + "ACGTTGCACCGT" * 20 + "\n")
    out = sh(
        "kpop-count -k 16 -l g -f g.fasta -o /dev/stdout", tmp_path
    )
    lines = out.splitlines()
    assert lines[0] == "\tg"
    # periodic sequence (period 12) -> 12 distinct windows
    assert len(lines) == 1 + 12
    # total count equals number of valid windows
    total = sum(int(ln.split("\t")[1]) for ln in lines[1:])
    assert total == 12 * 20 - 16 + 1


def test_countdb_distances_backend_jax(tmp_path):
    (tmp_path / "a.fasta").write_text(
        ">x1\nACGTACGTACGTACGTAAAA\n>x2\nACGTACGTACGTACGTAAAC\n"
        ">y1\nTTTTGGGGCCCCAAAATTTT\n"
    )
    sh(
        "kpop-count -k 4 -L -f a.fasta -o S && "
        "kpop-countdb -k S --distances '~.' '~.' DH && "
        "kpop-countdb -k S --backend jax --distances '~.' '~.' DJ",
        tmp_path,
    )
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType

    dh = KPopMatrix.of_binary(MatrixType.DMATRIX, str(tmp_path / "DH"))
    dj = KPopMatrix.of_binary(MatrixType.DMATRIX, str(tmp_path / "DJ"))
    assert dh.matrix.row_names == dj.matrix.row_names
    np.testing.assert_allclose(
        np.asarray(dj.matrix.data), np.asarray(dh.matrix.data),
        rtol=2e-5, atol=1e-6,
    )
