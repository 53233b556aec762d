"""ctypes binding for the native host runtime (kpop_native.cpp).

Builds the shared library on first use with g++ into a file named by a key
of the committed source and the host CPU (architecture and feature flags),
since ``-march=native`` code built on one host may not run on another; a
library built elsewhere is never loaded.  Falls back to the pure-numpy
paths if no compiler is available.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kpop_native.cpp")
_lock = threading.Lock()
_lib = None
_tried = False

_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _cpu_flags() -> str:
    """The host CPU's feature flags line from /proc/cpuinfo ('' if none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def _lib_path() -> str:
    """Library file for this source and this host CPU."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    return os.path.join(_DIR, "libkpop_native-%s.so" % h.hexdigest()[:16])


def _build(path: str) -> bool:
    """Compile into ``path`` atomically (concurrent test workers may build
    at once) and remove libraries built under other keys."""
    fd, tmp = tempfile.mkstemp(dir=_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [
        # -pthread: kpop_native.cpp spawns std::thread; on toolchains
        # older than glibc 2.34 thread construction throws at runtime
        # without it (inside a ctypes call, killing the process)
        "g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, path)
    for old in glob.glob(os.path.join(_DIR, "libkpop_native*.so")):
        if old != path:
            try:
                os.unlink(old)
            except FileNotFoundError:  # removed by a concurrent build
                pass
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.kpop_encode_dna.restype = _i64
        lib.kpop_encode_dna.argtypes = [_u8p, _i64, _i8p]
        lib.kpop_encode_protein.restype = _i64
        lib.kpop_encode_protein.argtypes = [_u8p, _i64, _i8p]
        lib.kpop_encode_batch.restype = None
        lib.kpop_encode_batch.argtypes = [
            _u8p, _i64p, _i64p, _i64, _i64, ctypes.c_int32, _i8p, _i64p,
        ]
        for fn in (lib.kpop_fasta_encode_batch, lib.kpop_fastq_encode_batch):
            fn.restype = _i64
            fn.argtypes = [
                _u8p, _i64, _i8p, _i64, _i64, _i64p, _i64p, _i64p, _i64p,
            ]
        lib.kpop_count_dense.restype = None
        lib.kpop_count_dense.argtypes = [
            _i8p, _i64, ctypes.c_int32, ctypes.c_int32, _i64p,
        ]
        lib.kpop_count_dense_batch.restype = None
        lib.kpop_count_dense_batch.argtypes = [
            _i8p, _i64, _i64, ctypes.c_int32, ctypes.c_int32, _i64p,
        ]
        lib.kpop_pack_2bit_batch.restype = None
        lib.kpop_pack_2bit_batch.argtypes = [_i8p, _i64, _i64, _u8p, _u8p]
        lib.kpop_format_tsv.restype = _i64
        lib.kpop_format_tsv.argtypes = [
            ctypes.POINTER(ctypes.c_double), _i64, _i64, ctypes.c_int32,
            _u8p, _i64p, _i64p, ctypes.c_int32, ctypes.c_int32,
            _u8p, _i64, ctypes.c_int32,
        ]
        lib.kpop_format_spectra_col.restype = _i64
        lib.kpop_format_spectra_col.argtypes = [
            ctypes.POINTER(ctypes.c_double), _i64, ctypes.c_int32,
            _u8p, _i64p, _i64p, _u8p, _i64,
        ]
        lib.kpop_format_spectra_entries.restype = _i64
        lib.kpop_format_spectra_entries.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
            _i64, ctypes.c_int32, _u8p, _i64,
        ]
        lib.kpop_format_summary.restype = _i64
        lib.kpop_format_summary.argtypes = [
            _u8p, _i64p, _i64p,  # query name blob/offs/lens
            ctypes.POINTER(ctypes.c_double),  # stats [rows, 4]
            ctypes.POINTER(ctypes.c_double),  # dists [rows, kcap] ordered
            ctypes.POINTER(ctypes.c_int32),  # tgt [rows, kcap] ordered
            _i64p, _i64, _i64,  # eff, rows, kcap
            _u8p, _i64p, _i64p,  # target name blob/offs/lens
            ctypes.c_int32, _u8p, _i64,  # precision, out, cap
        ]
        lib.kpop_parse_tsv.restype = _i64
        lib.kpop_parse_tsv.argtypes = [
            _u8p, _i64p, _i64p, _i64, _i64,
            ctypes.POINTER(ctypes.c_double), _i64p, _i64p, ctypes.c_int32,
        ]
        lib.kpop_spectra_parse.restype = _i64
        lib.kpop_spectra_parse.argtypes = [
            _u8p,
            _i64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double),
            _i8p,
            _i64p,
            _i64p,
            _i64,
            _i64p,
        ]
        _u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.kpop_sparse_create.restype = ctypes.c_void_p
        lib.kpop_sparse_create.argtypes = [_i64]
        lib.kpop_sparse_free.restype = None
        lib.kpop_sparse_free.argtypes = [ctypes.c_void_p]
        lib.kpop_sparse_clear.restype = None
        lib.kpop_sparse_clear.argtypes = [ctypes.c_void_p]
        lib.kpop_sparse_size.restype = _i64
        lib.kpop_sparse_size.argtypes = [ctypes.c_void_p]
        lib.kpop_sparse_add_codes.restype = None
        lib.kpop_sparse_add_codes.argtypes = [ctypes.c_void_p, _u64p, _i64]
        lib.kpop_sparse_count_seq.restype = None
        lib.kpop_sparse_count_seq.argtypes = [
            ctypes.c_void_p, _i8p, _i64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.kpop_sparse_count_batch.restype = None
        lib.kpop_sparse_count_batch.argtypes = [
            ctypes.c_void_p, _i8p, _i64, _i64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.kpop_count_dense_batch_mt.restype = None
        lib.kpop_count_dense_batch_mt.argtypes = [
            _i8p, _i64, _i64, ctypes.c_int32, ctypes.c_int32, _i64p,
            ctypes.c_int32,
        ]
        lib.kpop_sparse_extract.restype = _i64
        lib.kpop_sparse_extract.argtypes = [ctypes.c_void_p, _u64p, _i64p]
        lib.kpop_splits_centroids.restype = ctypes.c_void_p
        lib.kpop_splits_centroids.argtypes = [
            ctypes.POINTER(ctypes.c_double), _i64, ctypes.c_int32,
            ctypes.c_uint64,
        ]
        lib.kpop_splits_sizes.restype = None
        lib.kpop_splits_sizes.argtypes = [ctypes.c_void_p, _i64p, _i64p]
        lib.kpop_splits_fill.restype = None
        lib.kpop_splits_fill.argtypes = [
            ctypes.c_void_p, _i64p, _i64p, ctypes.POINTER(ctypes.c_double),
        ]
        lib.kpop_splits_free.restype = None
        lib.kpop_splits_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def encode_dna(seq: bytes) -> np.ndarray:
    lib = get_lib()
    out = np.empty(len(seq), dtype=np.int8)
    raw = np.frombuffer(seq, dtype=np.uint8)
    m = lib.kpop_encode_dna(
        raw.ctypes.data_as(_u8p), len(seq), out.ctypes.data_as(_i8p)
    )
    return out[:m]


def encode_protein(seq: bytes) -> np.ndarray:
    lib = get_lib()
    out = np.empty(len(seq), dtype=np.int8)
    raw = np.frombuffer(seq, dtype=np.uint8)
    m = lib.kpop_encode_protein(
        raw.ctypes.data_as(_u8p), len(seq), out.ctypes.data_as(_i8p)
    )
    return out[:m]


def encode_batch(
    seqs, protein: bool, length: int | None = None
) -> np.ndarray:
    """Batch lint+encode into a padded ``[n, L]`` int8 matrix (-1 pad).

    One C call replaces the per-sequence Python loop of the serving path;
    ``L`` is the longest encoded length (>= ``length`` if given), matching
    the numpy fallback in ops/encode.py byte for byte.
    """
    lib = get_lib()
    bs = [s.encode() if isinstance(s, str) else s for s in seqs]
    n = len(bs)
    lens = np.array([len(b) for b in bs], dtype=np.int64)
    offs = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    buf = b"".join(bs)
    raw = np.frombuffer(buf or b"\x00", dtype=np.uint8)
    cap = max(int(lens.max()) if n else 0, length or 0, 1)
    out = np.empty((n, cap), dtype=np.int8)
    enc_len = np.empty(n, dtype=np.int64)
    lib.kpop_encode_batch(
        raw.ctypes.data_as(_u8p),
        offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p),
        n,
        cap,
        int(protein),
        out.ctypes.data_as(_i8p),
        enc_len.ctypes.data_as(_i64p),
    )
    # explicit length pads AND truncates to it (the numpy fallback contract)
    width = length if length else max(int(enc_len.max()) if n else 0, 1)
    return np.ascontiguousarray(out[:, :width])


def fasta_encode_batch(
    buf: bytes, max_seqs: int, max_len: int, fastq: bool = False
):
    """Parse+encode up to max_seqs records from a text buffer.

    Returns (codes [n, max_len] int8, names list[str], seq_lens, consumed).
    """
    lib = get_lib()
    raw = np.frombuffer(buf, dtype=np.uint8)
    codes = np.empty((max_seqs, max_len), dtype=np.int8)
    name_off = np.empty(max_seqs, dtype=np.int64)
    name_len = np.empty(max_seqs, dtype=np.int64)
    seq_len = np.empty(max_seqs, dtype=np.int64)
    consumed = _i64(0)
    fn = lib.kpop_fastq_encode_batch if fastq else lib.kpop_fasta_encode_batch
    n = fn(
        raw.ctypes.data_as(_u8p),
        len(buf),
        codes.ctypes.data_as(_i8p),
        max_seqs,
        max_len,
        name_off.ctypes.data_as(_i64p),
        name_len.ctypes.data_as(_i64p),
        seq_len.ctypes.data_as(_i64p),
        ctypes.byref(consumed),
    )
    names = [
        buf[name_off[i] : name_off[i] + name_len[i]].decode()
        for i in range(n)
    ]
    return codes[:n], names, seq_len[:n], consumed.value


def pack_2bit_batch(codes: np.ndarray):
    """[n, L] int8 codes -> (packed [n, ceil(L/4)] u8, valid [n, ceil(L/8)] u8).

    The 2-bit wire format: 2.7x smaller host->device transfers than raw
    int8 codes; unpacked on device (ops/encode.unpack_2bit_batch)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n, L = codes.shape
    packed = np.empty((n, (L + 3) // 4), dtype=np.uint8)
    valid = np.empty((n, (L + 7) // 8), dtype=np.uint8)
    lib.kpop_pack_2bit_batch(
        codes.ctypes.data_as(_i8p), n, L,
        packed.ctypes.data_as(_u8p), valid.ctypes.data_as(_u8p),
    )
    return packed, valid


def spectra_parse(buf: bytes, max_entries: int | None = None):
    """Parse a ``.KPopSpectra.txt`` buffer into flat line arrays.

    Returns (kinds i8 [n] (0=entry, 1=header), codes u64 [n], counts f64 [n],
    labels list indexed by header position, consumed bytes).
    """
    lib = get_lib()
    raw = np.frombuffer(buf, dtype=np.uint8)
    cap = max_entries if max_entries is not None else buf.count(b"\n") + 1
    codes = np.empty(cap, dtype=np.uint64)
    counts = np.empty(cap, dtype=np.float64)
    kinds = np.empty(cap, dtype=np.int8)
    loff = np.empty(cap, dtype=np.int64)
    llen = np.empty(cap, dtype=np.int64)
    consumed = _i64(0)
    n = lib.kpop_spectra_parse(
        raw.ctypes.data_as(_u8p),
        len(buf),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        kinds.ctypes.data_as(_i8p),
        loff.ctypes.data_as(_i64p),
        llen.ctypes.data_as(_i64p),
        cap,
        ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError(f"malformed spectra line index {-1 - n}")
    labels = {}
    for i in np.nonzero(kinds[:n] == 1)[0]:
        labels[int(i)] = buf[loff[i] : loff[i] + llen[i]].decode()
    return kinds[:n], codes[:n], counts[:n], labels, consumed.value


def count_dense(codes: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    """Dense spectrum (int64[4^k]) of one encoded sequence."""
    lib = get_lib()
    spectrum = np.zeros(4**k, dtype=np.int64)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lib.kpop_count_dense(
        codes.ctypes.data_as(_i8p), len(codes), k, int(canonical),
        spectrum.ctypes.data_as(_i64p),
    )
    return spectrum


def count_dense_batch(
    codes: np.ndarray,
    k: int,
    canonical: bool,
    out: np.ndarray | None = None,
    threads: int = 1,
) -> np.ndarray:
    """Accumulate a [n, L] padded batch into one dense spectrum.

    ``threads > 1`` rolls sequence ranges in parallel with relaxed atomic
    adds — identical counts, reference-style chunk parallelism."""
    lib = get_lib()
    if out is None:
        out = np.zeros(4**k, dtype=np.int64)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    if threads > 1:
        lib.kpop_count_dense_batch_mt(
            codes.ctypes.data_as(_i8p), codes.shape[0], codes.shape[1], k,
            int(canonical), out.ctypes.data_as(_i64p), threads,
        )
    else:
        lib.kpop_count_dense_batch(
            codes.ctypes.data_as(_i8p), codes.shape[0], codes.shape[1], k,
            int(canonical), out.ctypes.data_as(_i64p),
        )
    return out


class SparseCounter:
    """Open-addressing k-mer count hash (large-k sparse counting).

    The native equivalent of the reference's bounded hash table
    (``KMers.IntHashFrequencies``, bin/KPopCount.ml:25,111-123): O(1)
    inserts per window instead of the numpy fallback's per-read sorted
    merge.  ``clear()`` keeps capacity for the -M dump-and-clear cycle.
    """

    def __init__(self, capacity_hint: int = 1 << 16):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.kpop_sparse_create(capacity_hint)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kpop_sparse_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.kpop_sparse_size(self._h))

    def add_codes(self, codes: np.ndarray) -> None:
        codes = np.ascontiguousarray(codes, dtype=np.uint64)
        self._lib.kpop_sparse_add_codes(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(codes),
        )

    def count_seq(
        self, codes: np.ndarray, k: int, canonical: bool, base: int
    ) -> None:
        """Count every valid k-window of an encoded (int8) sequence."""
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        self._lib.kpop_sparse_count_seq(
            self._h, codes.ctypes.data_as(_i8p), len(codes), k,
            int(canonical), base,
        )

    def count_batch(
        self,
        codes: np.ndarray,
        k: int,
        canonical: bool,
        base: int,
        threads: int = 1,
    ) -> None:
        """Count a padded ``[n, L]`` int8 batch (-1 pad), threaded: each
        thread counts a sequence range into its own hash, merged here —
        content identical to the sequential path."""
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        n, L = codes.shape
        self._lib.kpop_sparse_count_batch(
            self._h, codes.ctypes.data_as(_i8p), n, L, k, int(canonical),
            base, max(1, threads),
        )

    def extract(self):
        """All (codes, counts), sorted by code."""
        n = len(self)
        codes = np.empty(n, dtype=np.uint64)
        counts = np.empty(n, dtype=np.int64)
        if n:
            m = self._lib.kpop_sparse_extract(
                self._h,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                counts.ctypes.data_as(_i64p),
            )
            assert m == n
        return codes, counts

    def clear(self) -> None:
        self._lib.kpop_sparse_clear(self._h)


def splits_centroids(data: np.ndarray, seed: int):
    """Full centroids splits tree over [n, d] embeddings (annealed
    bipartitions, preorder).  Returns (offsets [S+1], members, weights)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    n, d = data.shape
    h = lib.kpop_splits_centroids(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, d, ctypes.c_uint64(seed & (2**64 - 1)),
    )
    try:
        n_splits = _i64(0)
        n_members = _i64(0)
        lib.kpop_splits_sizes(
            h, ctypes.byref(n_splits), ctypes.byref(n_members)
        )
        offsets = np.empty(n_splits.value + 1, dtype=np.int64)
        members = np.empty(max(n_members.value, 1), dtype=np.int64)
        weights = np.empty(max(n_splits.value, 1), dtype=np.float64)
        lib.kpop_splits_fill(
            h,
            offsets.ctypes.data_as(_i64p),
            members.ctypes.data_as(_i64p),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    finally:
        lib.kpop_splits_free(h)
    return offsets, members[: n_members.value], weights[: n_splits.value]


def _names_blob(prefixes):
    """Concatenate prefix strings into (blob u8, off i64, len i64) arrays."""
    bs = [p.encode() if isinstance(p, str) else p for p in prefixes]
    lens = np.array([len(b) for b in bs], dtype=np.int64)
    offs = np.zeros(len(bs), dtype=np.int64)
    if len(bs) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    blob = np.frombuffer(b"".join(bs) or b"\x00", dtype=np.uint8)
    return blob, offs, lens


def format_tsv(
    vals: np.ndarray,
    precision: int,
    prefixes=None,
    lead_sep: bool = False,
) -> bytes:
    """Format a [rows, cols] float64 block as TSV bytes (rows end in \\n).

    ``prefixes`` (one string per row: the row name, or name+metadata fields
    pre-joined with tabs) are emitted before the first value; every value is
    preceded by '\\t' except the first of a prefix-less, lead_sep-less row.
    Byte-identical to ``"\\t".join(prefix_parts + ["%.{p}g" % v ...])`` in
    Python: one C call replaces rows*cols interpreter-loop format calls.
    """
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    rows, cols = vals.shape
    if prefixes is not None:
        blob, offs, lens = _names_blob(prefixes)
        max_pre = int(lens.max()) if len(lens) else 0
    else:
        blob = np.zeros(1, dtype=np.uint8)
        offs = lens = np.zeros(max(rows, 1), dtype=np.int64)
        max_pre = 0
    pv = precision + 12
    cap = rows * (max_pre + cols * pv + 2) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.kpop_format_tsv(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows,
        cols,
        precision,
        blob.ctypes.data_as(_u8p),
        offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p),
        int(prefixes is not None),
        int(lead_sep),
        out.ctypes.data_as(_u8p),
        cap,
        os.cpu_count() or 1,
    )
    if n < 0:  # pragma: no cover - cap is sized to make this impossible
        raise RuntimeError("kpop_format_tsv buffer overflow")
    return out[:n].tobytes()


def format_spectra_col(
    vals: np.ndarray, precision: int, blob, offs, lens
) -> bytes:
    """Format the positive entries of one spectrum column as
    ``<name>\\t<value>\\n`` lines; (blob, offs, lens) from ``_names_blob``
    over the k-mer names (built once per export, reused per column)."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n = len(vals)
    max_pre = int(lens.max()) if len(lens) else 0
    pv = precision + 12
    cap = int(np.count_nonzero(vals > 0)) * (max_pre + pv) + 16
    out = np.empty(cap, dtype=np.uint8)
    m = lib.kpop_format_spectra_col(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        precision,
        blob.ctypes.data_as(_u8p),
        offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p),
        out.ctypes.data_as(_u8p),
        cap,
    )
    if m < 0:  # pragma: no cover
        raise RuntimeError("kpop_format_spectra_col buffer overflow")
    return out[:m].tobytes()


def format_summary(
    qnames,
    stats: np.ndarray,
    dists: np.ndarray,
    tgt: np.ndarray,
    eff: np.ndarray,
    cblob: np.ndarray,
    coffs: np.ndarray,
    clens: np.ndarray,
    precision: int = 15,
) -> bytes:
    """Format per-query distance-summary lines (lib/Matrix.ml:632-690):
    ``<name>\\t<mean>\\t<std>\\t<median>\\t<mad>(\\t<target>\\t<d>\\t<z>)*``.

    ``dists``/``tgt`` are ``[rows, kcap]`` pre-ordered (distance, then
    target index); only the first ``eff[i]`` entries of row i are emitted,
    and rows with ``eff[i] < 0`` are skipped (host-fallback rows the caller
    interleaves).  (cblob, coffs, clens) from :func:`_names_blob` over the
    target names.  Byte-identical to the Python ``"%.15g"`` assembly: one C
    call replaces rows*(5+3*eff) interpreter-loop format calls."""
    lib = get_lib()
    qblob, qoffs, qlens = _names_blob(qnames)
    stats = np.ascontiguousarray(stats, dtype=np.float64)
    dists = np.ascontiguousarray(dists, dtype=np.float64)
    tgt = np.ascontiguousarray(tgt, dtype=np.int32)
    eff = np.ascontiguousarray(eff, dtype=np.int64)
    rows, kcap = dists.shape
    pv = precision + 14
    max_c = int(clens.max()) if len(clens) else 0
    cap = int(
        (qlens + 4 * (pv + 1) + np.maximum(eff, 0) * (max_c + 2 * (pv + 1) + 3) + 2).sum()
    ) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.kpop_format_summary(
        qblob.ctypes.data_as(_u8p),
        qoffs.ctypes.data_as(_i64p),
        qlens.ctypes.data_as(_i64p),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tgt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        eff.ctypes.data_as(_i64p),
        rows,
        kcap,
        cblob.ctypes.data_as(_u8p),
        coffs.ctypes.data_as(_i64p),
        clens.ctypes.data_as(_i64p),
        precision,
        out.ctypes.data_as(_u8p),
        cap,
    )
    if n < 0:  # pragma: no cover - cap is sized to make this impossible
        raise RuntimeError("kpop_format_summary buffer overflow")
    return out[:n].tobytes()


def parse_tsv_body(data: bytes, starts, ends, cols):
    """Parse non-empty TSV matrix body lines into (vals [n, cols] f64,
    names list[str]); returns None if any line needs the tolerant Python
    reader (malformed float, wrong column count).

    ``starts``/``ends`` are int64 arrays of line byte spans within
    ``data``.  One C call (threaded over line chunks) replaces a
    per-cell ``float()`` interpreter loop — the read-side twin of
    ``format_tsv`` for multi-GB .KPopTwisted.txt-scale tables."""
    lib = get_lib()
    raw = np.frombuffer(data or b"\x00", dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    n = len(starts)
    vals = np.empty((n, cols), dtype=np.float64)
    name_off = np.empty(n, dtype=np.int64)
    name_len = np.empty(n, dtype=np.int64)
    ret = lib.kpop_parse_tsv(
        raw.ctypes.data_as(_u8p),
        starts.ctypes.data_as(_i64p),
        ends.ctypes.data_as(_i64p),
        n,
        cols,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        name_off.ctypes.data_as(_i64p),
        name_len.ctypes.data_as(_i64p),
        os.cpu_count() or 1,
    )
    if ret < 0:
        return None
    names = [
        data[name_off[i] : name_off[i] + name_len[i]].decode()
        for i in range(n)
    ]
    return vals, names


def format_spectra_entries(codes, counts, hex_width: int):
    """Format spectrum entry lines ``<hex>\\t<count>\\n`` (zero-padded hex,
    integral counts as integers) in one C call; returns bytes, or None if a
    code exceeds hex_width (caller falls back to the Python writer)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    n = len(codes)
    cap = n * (hex_width + 32) + 16
    out = np.empty(cap, dtype=np.uint8)
    m = lib.kpop_format_spectra_entries(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        hex_width,
        out.ctypes.data_as(_u8p),
        cap,
    )
    if m < 0:
        return None
    return out[:m].tobytes()
