"""The C++ native host runtime must agree with the numpy golden paths."""

import os

import numpy as np
import pytest

from kpop_tpu import native
from kpop_tpu.core import kmers

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


def random_dna(rng, n):
    return "".join(
        rng.choice(list("ACGTNacgtu-"), p=[0.2, 0.2, 0.2, 0.2, 0.05, 0.04,
                                           0.04, 0.03, 0.02, 0.01, 0.01],
                   size=n)
    )


def test_encode_matches_python():
    rng = np.random.default_rng(0)
    for _ in range(20):
        seq = random_dna(rng, 500)
        want = kmers.encode_dna(seq)
        got = native.encode_dna(seq.encode())
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,canonical", [(5, True), (5, False), (12, True)])
def test_count_dense_matches_python(k, canonical):
    rng = np.random.default_rng(1)
    space = kmers.KmerSpace("DNA-ds" if canonical else "DNA-ss", k)
    seq = random_dna(rng, 3000)
    codes = kmers.encode_dna(seq)
    want = np.zeros(space.n_kmers, dtype=np.int64)
    np.add.at(want, space.window_codes(codes).astype(np.int64), 1)
    got = native.count_dense(codes, k, canonical)
    np.testing.assert_array_equal(got, want)


def test_fasta_encode_batch():
    buf = b">s1 desc\nACGT\nACGT\n>s2\nNNAC-GT\n>s3\nacgu\n"
    codes, names, seq_lens, consumed = native.fasta_encode_batch(buf, 10, 12)
    assert names == ["s1", "s2", "s3"]
    assert consumed == len(buf)
    np.testing.assert_array_equal(seq_lens, [8, 6, 4])
    np.testing.assert_array_equal(
        codes[0], [0, 1, 2, 3, 0, 1, 2, 3, -1, -1, -1, -1]
    )
    # dash removed, N -> -1 break
    np.testing.assert_array_equal(codes[1][:6], [-1, -1, 0, 1, 2, 3])
    np.testing.assert_array_equal(codes[2][:4], [0, 1, 2, 3])  # u -> T


def test_fasta_encode_batch_truncates_and_limits():
    buf = b">a\nACGTACGT\n>b\nTTTT\n"
    codes, names, seq_lens, consumed = native.fasta_encode_batch(buf, 1, 4)
    assert names == ["a"]
    assert seq_lens[0] == 8  # pre-truncation length reported
    np.testing.assert_array_equal(codes[0], [0, 1, 2, 3])
    assert consumed < len(buf)  # second record untouched, stream can refill


def test_fastq_encode_batch():
    buf = b"@r1 x\nACGT\n+\nIIII\n@r2\nTT-T\n+anything\nIII\n"
    codes, names, seq_lens, consumed = native.fasta_encode_batch(
        buf, 10, 6, fastq=True
    )
    assert names == ["r1", "r2"]
    np.testing.assert_array_equal(codes[0][:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(codes[1][:3], [3, 3, 3])
    assert seq_lens[1] == 3
    assert consumed == len(buf)


def test_count_dense_batch_accumulates():
    rng = np.random.default_rng(2)
    space = kmers.KmerSpace("DNA-ds", 4)
    seqs = [random_dna(rng, 200) for _ in range(5)]
    batch = np.full((5, 250), -1, dtype=np.int8)
    want = np.zeros(space.n_kmers, dtype=np.int64)
    for i, s in enumerate(seqs):
        e = kmers.encode_dna(s)
        batch[i, : len(e)] = e
        np.add.at(want, space.window_codes(e).astype(np.int64), 1)
    got = native.count_dense_batch(batch, 4, True)
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_roundtrip():
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from kpop_tpu.ops.encode import unpack_2bit_batch
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 4, size=(4, 37)).astype(np.int8)
    packed, valid = native.pack_2bit_batch(codes)
    assert packed.shape == (4, 10) and valid.shape == (4, 5)
    got = np.asarray(unpack_2bit_batch(jnp.asarray(packed), jnp.asarray(valid), 37))
    np.testing.assert_array_equal(got, codes)


def random_protein(rng, n):
    pool = list(kmers.PROTEIN_ALPHABET + kmers.PROTEIN_ALPHABET.lower() + "XBZ*-")
    return "".join(rng.choice(pool, size=n))


def test_encode_protein_matches_python():
    rng = np.random.default_rng(4)
    for _ in range(20):
        seq = random_protein(rng, 300)
        want = kmers.encode_protein(seq)
        got = native.encode_protein(seq.encode())
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("protein", [False, True])
def test_encode_batch_matches_numpy_fallback(protein):
    """native.encode_batch must equal the numpy loop in encode_reads_host
    byte for byte, including the lint (dash removal, lowercase, breaks),
    the padded width, and explicit-length truncation."""
    rng = np.random.default_rng(5)
    gen = random_protein if protein else random_dna
    enc = kmers.encode_protein if protein else kmers.encode_dna
    seqs = [gen(rng, int(n)) for n in rng.integers(5, 120, size=16)]

    def numpy_batch(seqs, length=None):
        encoded = [enc(s) for s in seqs]
        L = length or max((len(e) for e in encoded), default=0)
        L = max(L, 1)
        out = np.full((len(encoded), L), -1, dtype=np.int8)
        for i, e in enumerate(encoded):
            out[i, : min(len(e), L)] = e[:L]
        return out

    got = native.encode_batch(seqs, protein)
    np.testing.assert_array_equal(got, numpy_batch(seqs))
    got = native.encode_batch(seqs, protein, length=40)  # truncation
    np.testing.assert_array_equal(got, numpy_batch(seqs, length=40))
    got = native.encode_batch(seqs, protein, length=500)  # extra pad
    np.testing.assert_array_equal(got, numpy_batch(seqs, length=500))


def test_format_tsv_matches_python_percent_g():
    """The C text formatter (to_chars + integer fast path) must be
    byte-identical to Python's "%.Ng" across magnitudes, specials, and
    precisions — it replaces the interpreter loop in to_table/write_text."""
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    vals = np.concatenate(
        [
            rng.standard_normal(4000)
            * 10.0 ** rng.integers(-308, 308, 4000).astype(np.float64),
            rng.integers(-(10**14), 10**14, 2000).astype(np.float64),
            np.array(
                [0.0, -0.0, 1e15, -1e15, 1e15 - 1, 2.0**53, -(2.0**53),
                 np.inf, -np.inf, np.nan, 5e-324, 1e-308, 0.1, 1 / 3,
                 1e16, 9.999999999999e14]
            ),
        ]
    )
    for prec in (1, 6, 12, 15, 17, 40):
        fmt = "%%.%dg" % prec
        got = native.format_tsv(vals.reshape(-1, 1), prec, None).decode()
        assert got == "\n".join(fmt % v for v in vals) + "\n"


def test_format_tsv_threaded_path_with_prefixes():
    """Row counts above the threading threshold still produce in-order,
    byte-identical output with per-row prefixes."""
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(3)
    m = rng.standard_normal((20000, 5))
    prefixes = ["row_%d\tmeta%d" % (i, i % 7) for i in range(len(m))]
    got = native.format_tsv(m, 12, prefixes).decode()
    want = "".join(
        p + "\t" + "\t".join("%.12g" % v for v in row) + "\n"
        for p, row in zip(prefixes, m)
    )
    assert got == want


def test_format_spectra_col_drops_nonpositive():
    if not native.available():
        pytest.skip("native lib unavailable")
    vals = np.array([0.0, 1.5, -2.0, 3.0, np.nan, 0.25])
    names = ["k%d" % i for i in range(len(vals))]
    blob = native._names_blob(names)
    got = native.format_spectra_col(vals, 12, *blob).decode()
    assert got == "k1\t1.5\nk3\t3\nk5\t0.25\n"


def test_read_text_native_matches_python_reader():
    """The threaded C TSV parser must agree exactly with the per-cell
    Python reader (file path and StringIO path)."""
    if not native.available():
        pytest.skip("native lib unavailable")
    import io as _io
    from kpop_tpu.core.matrix import NamedMatrix

    rng = np.random.default_rng(11)
    data = np.concatenate(
        [
            rng.standard_normal((50, 7)),
            rng.integers(0, 1000, (50, 7)).astype(np.float64),
            rng.standard_normal((50, 7)) * 1e-200,
        ]
    )
    m = NamedMatrix(
        ["row %d" % i for i in range(150)],
        ["c%d" % j for j in range(7)],
        data,
    )
    buf = _io.StringIO()
    m.write_text(buf)
    text = buf.getvalue()
    # StringIO path (no .buffer attribute)
    m2 = NamedMatrix.read_text(_io.StringIO(text))
    # file path (buffer fast path)
    import tempfile, os as _os

    with tempfile.TemporaryDirectory() as td:
        p = _os.path.join(td, "m.txt")
        with open(p, "w") as f:
            f.write(text)
        with open(p) as f:
            m3 = NamedMatrix.read_text(f)
    for got in (m2, m3):
        assert got.row_names == m.row_names
        assert got.col_names == m.col_names
        assert np.array_equal(np.round(got.data, 9), np.round(data, 9))


def test_read_text_ragged_rows_still_raise():
    """A ragged body makes the native parser bail; the tolerant Python
    reader then raises IncompatibleGeometries exactly as before."""
    import io as _io
    from kpop_tpu.core.matrix import IncompatibleGeometries, NamedMatrix

    text = '""\t"a"\t"b"\n"r1"\t1\t2\n"r2"\t3\n'
    with pytest.raises(IncompatibleGeometries):
        NamedMatrix.read_text(_io.StringIO(text))


def test_format_spectra_entries_matches_python_writer():
    """The C spectrum-entry formatter must match io.spectra's Python
    writer byte for byte (zero-padded hex, %d integers, %.15g floats)."""
    if not native.available():
        pytest.skip("native lib unavailable")
    import io as _io
    from kpop_tpu.io import spectra as spectra_io

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16**5, 3000).astype(np.uint64)
    for counts in (
        rng.integers(1, 10**9, 3000).astype(np.int64),
        rng.integers(1, 100, 3000) * 0.125,
    ):
        blob = native.format_spectra_entries(codes, counts, 5)
        buf = _io.StringIO()
        spectra_io.write_spectrum_entries(
            buf, ["%05x" % int(c) for c in codes], counts
        )
        assert blob.decode() == buf.getvalue()
    # a code wider than hex_width must refuse (Python would print it wider)
    assert (
        native.format_spectra_entries(
            np.array([16**5], np.uint64), np.ones(1), 5
        )
        is None
    )


def test_read_text_specials_and_fuzz_parity():
    """Randomized tables (mixed magnitudes, integers, inf/nan) must parse
    identically through the native and Python readers."""
    if not native.available():
        pytest.skip("native lib unavailable")
    import io as _io
    from kpop_tpu.core import matrix as matrix_mod
    from kpop_tpu.core.matrix import NamedMatrix

    rng = np.random.default_rng(23)
    data = rng.standard_normal((40, 9)) * 10.0 ** rng.integers(
        -250, 250, (40, 9)
    ).astype(np.float64)
    data[3, 4] = np.inf
    data[5, 1] = -np.inf
    data[7, 0] = np.nan
    data[9, :] = rng.integers(0, 2**40, 9).astype(np.float64)
    m = NamedMatrix(
        ["r%d" % i for i in range(40)], ["c%d" % j for j in range(9)], data
    )
    buf = _io.StringIO()
    m.write_text(buf)
    text = buf.getvalue()
    native_m = NamedMatrix.read_text(_io.StringIO(text))
    orig = matrix_mod.NamedMatrix._parse_body_native
    try:
        matrix_mod.NamedMatrix._parse_body_native = classmethod(
            lambda cls, b, h: None
        )
        python_m = NamedMatrix.read_text(_io.StringIO(text))
    finally:
        matrix_mod.NamedMatrix._parse_body_native = orig
    assert native_m.row_names == python_m.row_names
    assert native_m.col_names == python_m.col_names
    a, b = native_m.data, python_m.data
    both_nan = np.isnan(a) & np.isnan(b)
    assert np.array_equal(a[~both_nan], b[~both_nan])
    assert np.isnan(a[7, 0]) and np.isinf(a[3, 4])


def test_to_table_utf8_names_survive_native_formatter(tmp_path):
    """Non-ASCII sample names / metadata must round-trip through the
    native block formatter exactly as through the Python writer."""
    from kpop_tpu.core.counter_db import CounterDB, TableFilter

    db = CounterDB(
        row_names=["aa", "bb"],
        col_names=["samplé_1", "пример_2"],
        counts=np.array([[1, 2], [3, 4]], dtype=np.int32),
    )
    out = tmp_path / "t"
    db.to_table(str(out), TableFilter())
    text = (tmp_path / "t.KPopCounter.txt").read_text()
    assert "samplé_1" in text and "пример_2" in text
    assert text.splitlines()[1] == "aa\t1\t2"


def test_read_text_partially_consumed_stream(tmp_path):
    """read_text on a stream that was already read from must not silently
    lose the text layer's look-ahead (the bytes fast path requires a fresh
    stream; consumed streams take the text path)."""
    from kpop_tpu.core.matrix import NamedMatrix

    p = tmp_path / "m.txt"
    rows = ['""\t"a"\t"b"'] + ['"r%d"\t%d\t%d' % (i, i, i + 1) for i in range(500)]
    p.write_text("\n".join(rows) + "\n")
    with open(p) as f:
        first = f.readline()
        assert first.startswith('""')
        m = NamedMatrix.read_text(f)
    # the real header was consumed, so r0's line becomes the header and
    # the remaining 499 rows are all parsed (the bug: an EMPTY matrix,
    # because buffer.read() skipped the text layer's look-ahead)
    assert m.n_rows == 499
    assert m.row_names[0] == "r1" and m.row_names[-1] == "r499"


def test_read_text_crlf(tmp_path):
    """CRLF files must keep parsing through the bytes fast path."""
    from kpop_tpu.core.matrix import NamedMatrix

    p = tmp_path / "m.txt"
    body = '""\t"a"\t"b"\r\n"r1"\t1\t2\r\n"r2"\t3.5\t-4\r\n'
    p.write_bytes(body.encode())
    with open(p) as f:
        m = NamedMatrix.read_text(f)
    assert m.col_names == ["a", "b"]
    assert m.row_names == ["r1", "r2"]
    np.testing.assert_allclose(m.data, [[1, 2], [3.5, -4]])


@pytest.mark.parametrize("bad", ["+-5", "nan(ind)", "++3", "+ 5"])
def test_parse_tsv_rejects_python_invalid_floats(tmp_path, bad):
    """Fields Python float() rejects must not silently parse natively:
    the native parser bails and the Python reader raises as before."""
    from kpop_tpu.core.matrix import NamedMatrix

    with pytest.raises(ValueError):
        float(bad)  # the contract under test
    p = tmp_path / "m.txt"
    p.write_text('""\t"a"\t"b"\n"r1"\t1\t%s\n' % bad)
    with pytest.raises(ValueError):
        with open(p) as f:
            NamedMatrix.read_text(f)


def test_parse_tsv_still_accepts_python_valid_floats(tmp_path):
    """Quoted / space-padded / signed / special fields Python accepts must
    keep parsing (either natively or via fallback) with the same values."""
    from kpop_tpu.core.matrix import NamedMatrix

    p = tmp_path / "m.txt"
    p.write_text(
        '""\t"a"\t"b"\t"c"\n'
        '"r1"\t"1.5"\t +2.5 \t-inf\n'
        '"r2"\tnan\t"1e-300"\t3\n'
    )
    with open(p) as f:
        m = NamedMatrix.read_text(f)
    assert m.data[0][0] == 1.5 and m.data[0][1] == 2.5
    assert np.isneginf(m.data[0][2])
    assert np.isnan(m.data[1][0])
    assert m.data[1][1] == 1e-300 and m.data[1][2] == 3


@pytest.mark.parametrize(
    "content,k",
    [("DNA-ds", 15), ("DNA-ds", 18), ("DNA-ds", 30), ("DNA-ss", 20),
     ("protein", 8), ("protein", 12)],
)
def test_sparse_counter_matches_window_codes(content, k):
    """The C++ open-addressing hash counter (large-k path) must agree with
    the vectorized numpy window extraction + merge, including break
    handling and canonical DNA-ds codes."""
    from kpop_tpu.core.kmers import KmerSpace

    space = KmerSpace(content, k)
    rng = np.random.default_rng(7)
    if content == "protein":
        alpha = list("ACDEFGHIKLMNPQRSTVWYXz-")
        seqs = ["".join(rng.choice(alpha, size=200)) for _ in range(30)]
        enc = kmers.encode_protein
    else:
        seqs = [random_dna(rng, 400) for _ in range(30)]
        enc = kmers.encode_dna
    h = native.SparseCounter()
    want_codes = np.zeros(0, np.uint64)
    want_counts = np.zeros(0, np.int64)
    for seq in seqs:
        codes = enc(seq)
        h.count_seq(
            np.asarray(codes, np.int8), k, space.canonical, space.base
        )
        wc = space.window_codes(np.asarray(codes))
        allc = np.concatenate([want_codes, wc])
        uniq, inv = np.unique(allc, return_inverse=True)
        merged = np.zeros(len(uniq), np.int64)
        np.add.at(
            merged, inv, np.concatenate([want_counts, np.ones(len(wc), np.int64)])
        )
        want_codes, want_counts = uniq, merged
    got_codes, got_counts = h.extract()
    np.testing.assert_array_equal(got_codes, want_codes)
    np.testing.assert_array_equal(got_counts, want_counts)


def test_sparse_counter_growth_and_clear():
    """Growth across several rehashes and dump-and-clear reuse."""
    rng = np.random.default_rng(8)
    h = native.SparseCounter(capacity_hint=4)
    codes = rng.integers(0, 1 << 50, size=200_000).astype(np.uint64)
    h.add_codes(codes)
    h.add_codes(codes[:1000])
    uniq, cnt = np.unique(codes, return_counts=True)
    cnt2 = cnt.copy()
    u1, c1 = np.unique(codes[:1000], return_counts=True)
    cnt2[np.searchsorted(uniq, u1)] += c1
    got_codes, got_counts = h.extract()
    np.testing.assert_array_equal(got_codes, uniq)
    np.testing.assert_array_equal(got_counts, cnt2)
    h.clear()
    assert len(h) == 0
    h.add_codes(np.array([5, 5, 7], dtype=np.uint64))
    gc, gn = h.extract()
    np.testing.assert_array_equal(gc, [5, 7])
    np.testing.assert_array_equal(gn, [2, 1])


def test_count_reads_large_k_native_matches_numpy(tmp_path):
    """count_reads at k=18 (sparse native hash) must emit byte-identical
    spectra to the pure-numpy golden path, including -M dump-and-clear
    eviction duplicates (bin/KPopCount.ml:116-123 semantics)."""
    import io as _io

    from kpop_tpu.core import count as count_mod
    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.io.reads import FastaInput

    rng = np.random.default_rng(9)
    fa = tmp_path / "r.fasta"
    with open(fa, "w") as f:
        for i in range(12):
            f.write(">r%d\n%s\n" % (i, random_dna(rng, 600)))
    space = KmerSpace("DNA-ds", 18)

    def run(use_native, max_results_size):
        out = _io.StringIO()
        orig_acc = count_mod.SpectrumAccumulator
        orig_sparse = count_mod._native_sparse_counter
        if not use_native:
            count_mod._native_sparse_counter = lambda s: None

            def acc_no_native(space, **kw):
                kw["use_native"] = False
                return orig_acc(space, **kw)

            count_mod.SpectrumAccumulator = acc_no_native
        try:
            count_mod.count_reads(
                [FastaInput(str(fa))], space, out, label="L",
                max_results_size=max_results_size,
            )
        finally:
            count_mod.SpectrumAccumulator = orig_acc
            count_mod._native_sparse_counter = orig_sparse
        return out.getvalue()

    for mrs in (10**9, 500):  # no eviction / eviction every ~1 read
        got = run(True, mrs)
        want = run(False, mrs)
        assert got == want
        if mrs == 500:
            assert got.count("\t") > 1  # eviction produced duplicate dumps


@pytest.mark.parametrize("k,mrs", [(6, 10**9), (6, 400), (18, 10**9), (18, 800)])
def test_count_reads_batched_threads_byte_identical(tmp_path, k, mrs):
    """-l mode batched threaded counting (dense atomics / per-thread
    hashes) must emit byte-identical spectra to the sequential per-read
    path, including when -M eviction forces the per-read fallback."""
    import io as _io

    from kpop_tpu.core import count as count_mod
    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.io.reads import FastaInput

    rng = np.random.default_rng(10)
    fa = tmp_path / "r.fasta"
    with open(fa, "w") as f:
        for i in range(40):
            f.write(">r%d\n%s\n" % (i, random_dna(rng, 300)))
    space = KmerSpace("DNA-ds", k)

    def run(threads, batch_bytes=None):
        out = _io.StringIO()
        orig = count_mod.BATCH_ENCODE_BYTES
        if batch_bytes is not None:
            count_mod.BATCH_ENCODE_BYTES = batch_bytes
        try:
            count_mod.count_reads(
                [FastaInput(str(fa))], space, out, label="L",
                max_results_size=mrs, threads=threads,
            )
        finally:
            count_mod.BATCH_ENCODE_BYTES = orig
        return out.getvalue()

    base = run(threads=1, batch_bytes=1)  # force per-read flushes
    for threads in (1, 4):
        got = run(threads=threads)  # large batches
        assert got == base, (k, mrs, threads)


def test_sparse_count_batch_matches_sequential():
    rng = np.random.default_rng(11)
    codes = rng.integers(-1, 4, size=(37, 500)).astype(np.int8)
    a = native.SparseCounter()
    a.count_batch(codes, 15, True, 4, threads=1)
    b = native.SparseCounter()
    b.count_batch(codes, 15, True, 4, threads=5)
    ca, na = a.extract()
    cb, nb = b.extract()
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(na, nb)


def test_count_dense_batch_mt_matches_sequential():
    rng = np.random.default_rng(12)
    codes = rng.integers(-1, 4, size=(33, 400)).astype(np.int8)
    seq = native.count_dense_batch(codes, 7, True, threads=1)
    mt = native.count_dense_batch(codes, 7, True, threads=4)
    np.testing.assert_array_equal(seq, mt)


def test_library_is_keyed_by_source_and_host(monkeypatch):
    path = native._lib_path()
    assert os.path.basename(path).startswith("libkpop_native-")
    monkeypatch.setattr(native, "_cpu_flags", lambda: "another host")
    assert native._lib_path() != path


def test_library_rebuilds_when_its_key_differs(monkeypatch):
    """A library built under another key (another host or source) is never
    loaded: a new key means a build of a new file."""
    built = []
    monkeypatch.setattr(native, "_cpu_flags", lambda: "another host")
    monkeypatch.setattr(native, "_build",
                        lambda path: built.append(path) or False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert built == [native._lib_path()]
