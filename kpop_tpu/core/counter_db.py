"""Spectrum database: the ``KPopCountDB`` capability.

Array-first re-design of the reference's ``KMerDB`` (lib/KMerDB.ml): the store
is one contiguous ``[n_rows(kmers), n_cols(samples)]`` int32 matrix (the
reference keeps one int32 Bigarray per spectrum, lib/KMerDB.ml:33-62) plus
name tables and string metadata.  All per-cell loops become vectorized numpy
/ JAX array ops.

Capabilities mapped from the reference:

- ingest text spectra / metadata     add_files / add_meta   (lib/KMerDB.ml:433-575)
- regexp selection engine            selected_from_regexps  (:577-613)
- combine spectra (mean/median)      add_combined_selected  (:615-736)
- split into class representatives   split_spectra          (:787-810)
- k-mer distillation                 distill_kmers          (:816-976)
- transformed table/spectra export   to_table / to_spectra  (:978-1239)
- raw-spectrum distances             to_distances           (:1240-1278)
- binary round-trip                  to_binary / of_binary  (:389-430)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import IO, Dict, List, Sequence, Tuple

import numpy as np

from ..io import framed
from ..io import spectra as spectra_io
from ..utils.naming import (
    COUNTER_BIN_EXT,
    COUNTER_TABLE_EXT,
    close_if_owned,
    open_in,
    open_in_bin,
    open_out,
    open_out_bin,
    with_ext,
)
from ..utils.quoting import strip_external_quotes_and_check
from .kmers import hex_labels_vectorized
from .matrix import MatrixType, NamedMatrix
from .transforms import StatsTable, Transformation, apply_transform, stats_table


def _native_formatter():
    """The native module when the C text formatter is available, else None.

    Table/spectra export formatting is the host hot loop of the reference's
    chunk-parallel writers (lib/KMerDB.ml:1004-1239); the C formatter
    replaces rows*cols interpreter-level "%.Ng" calls per block."""
    try:
        from .. import native
    except Exception:
        return None
    return native if native.available() else None

BINARY_TAG = "KPopCounter"


class WrongNumberOfColumns(ValueError):
    pass


class ClassesLabelNotFound(KeyError):
    pass


class ClassLabelIsAlsoSpectrumName(ValueError):
    pass


class InvalidNumberOfClasses(ValueError):
    pass


class UnknownCombinationCriterion(ValueError):
    pass


@dataclass
class TableFilter:
    """Export filter (reference ``KMerDB.TableFilter``, lib/KMerDB.ml:978-999)."""

    print_row_names: bool = True
    print_col_names: bool = True
    print_metadata: bool = False
    transpose: bool = False
    transform: Transformation = field(default_factory=Transformation)
    print_zero_rows: bool = False
    filter_columns: frozenset = frozenset()
    precision: int = 15


@dataclass
class CounterDB:
    row_names: List[str] = field(default_factory=list)  # k-mer hex labels
    col_names: List[str] = field(default_factory=list)  # sample labels
    meta_names: List[str] = field(default_factory=list)
    # meta[col][meta_idx] -> string value
    meta: List[List[str]] = field(default_factory=list)
    counts: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.int32)
    )  # [n_rows, n_cols]

    _row_idx: Dict[str, int] = field(default_factory=dict, repr=False)
    _col_idx: Dict[str, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._row_idx = {n: i for i, n in enumerate(self.row_names)}
        self._col_idx = {n: i for i, n in enumerate(self.col_names)}
        # amortized growth: the storage buffer over-allocates 1.4x like the
        # reference (lib/KMerDB.ml:316-365); ``counts`` is the exact view
        self._buf = np.asarray(self.counts)
        self.counts = self._buf[: self.n_rows, : self.n_cols]

    def _grow(self, add_rows: int, add_cols: int) -> None:
        need_r = self.n_rows + add_rows
        need_c = self.n_cols + add_cols
        cap_r, cap_c = self._buf.shape
        if need_r > cap_r or need_c > cap_c:
            new_r = max(need_r, int(cap_r * 1.4)) if need_r > cap_r else cap_r
            new_c = max(need_c, int(cap_c * 1.4)) if need_c > cap_c else cap_c
            buf = np.zeros((new_r, new_c), dtype=self._buf.dtype)
            buf[: self.n_rows, : self.n_cols] = self.counts
            self._buf = buf
        self.counts = self._buf[:need_r, :need_c]
        self.counts[self.n_rows :, :] = 0
        self.counts[:, self.n_cols :] = 0

    # ---------------- shape ----------------

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    @property
    def n_cols(self) -> int:
        return len(self.col_names)

    @property
    def n_meta(self) -> int:
        return len(self.meta_names)

    def summary_lines(self, verbose: bool = False) -> List[str]:
        """Reference ``output_summary`` (lib/KMerDB.ml:291-314)."""
        out = [
            "[Spectrum labels (%d)]:%s"
            % (self.n_cols, "".join(" '%s'" % s for s in self.col_names))
        ]
        if verbose:
            out.append(
                "[K-mer hashes (%d)]:%s"
                % (self.n_rows, "".join(" '%s'" % s for s in self.row_names))
            )
        out.append(
            "[Meta-data fields (%d)]:%s"
            % (self.n_meta, "".join(" '%s'" % s for s in self.meta_names))
        )
        return out

    # ---------------- growth ----------------

    def _ensure_col(self, label: str) -> int:
        idx = self._col_idx.get(label)
        if idx is not None:
            return idx
        idx = self.n_cols
        self._grow(0, 1)
        self._col_idx[label] = idx
        self.col_names.append(label)
        self.meta.append([""] * self.n_meta)
        return idx

    def _ensure_rows(self, labels: Sequence[str]) -> np.ndarray:
        """Vectorized row creation; returns indices for ``labels``."""
        new = [l for l in labels if l not in self._row_idx]
        if new:
            seen = set()
            fresh = []
            for l in new:
                if l not in seen:
                    seen.add(l)
                    fresh.append(l)
            base = self.n_rows
            self._grow(len(fresh), 0)
            for i, l in enumerate(fresh):
                self._row_idx[l] = base + i
            self.row_names.extend(fresh)
        return np.array([self._row_idx[l] for l in labels], dtype=np.int64)

    # ---------------- ingest ----------------

    def add_spectra_stream(self, f: IO[str]) -> int:
        """Parse a ``.KPopSpectra.txt`` stream into the DB (accumulating
        duplicates, lib/KMerDB.ml:561-562).  Returns #spectra read."""
        n = 0
        for label, entries in spectra_io.iter_spectra(f):
            col = self._ensure_col(label)
            if entries:
                labels = [e[0] for e in entries]
                vals = np.array([e[1] for e in entries])
                rows = self._ensure_rows(labels)
                np.add.at(
                    self.counts[:, col], rows, vals.astype(self.counts.dtype)
                )
            n += 1
        return n

    # -------- native fast ingest --------

    _code_index: tuple | None = None  # (sorted codes u64, row ids i64)
    _code_cache_width: int = -1
    _code_cache_rows: int = -1

    def _append_new_rows(self, labels: List[str]) -> np.ndarray:
        """Bulk-append rows known to be new and distinct (fast path)."""
        base = self.n_rows
        self._grow(len(labels), 0)
        self._row_idx.update(zip(labels, range(base, base + len(labels))))
        self.row_names.extend(labels)
        return np.arange(base, base + len(labels), dtype=np.int64)

    def _rebuild_code_index(self, width: int) -> None:
        codes, ids = [], []
        for name, idx in self._row_idx.items():
            if len(name) == width:
                try:
                    codes.append(int(name, 16))
                    ids.append(idx)
                except ValueError:
                    pass
        ca = np.array(codes, dtype=np.uint64)
        ia = np.array(ids, dtype=np.int64)
        order = np.argsort(ca)
        self._code_index = (ca[order], ia[order])
        self._code_cache_width = width
        self._code_cache_rows = self.n_rows

    def _codes_to_rows(self, codes: np.ndarray, width: int) -> np.ndarray:
        """Vectorized code -> row-index mapping (binary search over the
        sorted known-code table); hex labels are formatted only for codes
        never seen before.  The ingest hot path for big DBs."""
        if (
            self._code_index is None
            or self._code_cache_width != width
            or self._code_cache_rows != self.n_rows
        ):
            self._rebuild_code_index(width)
        sorted_codes, row_ids = self._code_index
        pos = np.searchsorted(sorted_codes, codes)
        safe = np.minimum(pos, max(len(sorted_codes) - 1, 0))
        found = (
            (pos < len(sorted_codes)) & (sorted_codes[safe] == codes)
            if len(sorted_codes)
            else np.zeros(len(codes), dtype=bool)
        )
        out = np.empty(len(codes), dtype=np.int64)
        out[found] = row_ids[safe[found]]
        if not found.all():
            new_codes = np.unique(codes[~found])
            labels = hex_labels_vectorized(new_codes, width)
            new_ids = self._append_new_rows(labels)
            # merge into the sorted index
            allc = np.concatenate([sorted_codes, new_codes])
            alli = np.concatenate([row_ids, new_ids])
            order = np.argsort(allc)
            self._code_index = (allc[order], alli[order])
            self._code_cache_rows = self.n_rows
            sorted_codes, row_ids = self._code_index
            pos = np.searchsorted(sorted_codes, codes[~found])
            out[~found] = row_ids[pos]
        return out

    _last_ingest_col: int | None = None

    def add_spectra_bytes(self, buf: bytes, allow_continuation: bool = False) -> int:
        """Ingest a ``.KPopSpectra.txt`` byte buffer via the C++ line
        parser; falls back to the text path without the native lib.
        Assumes the uniform fixed-width hex labels kpop-count emits.
        ``allow_continuation`` lets a buffer start with entry lines that
        belong to the previous buffer's last spectrum (chunked refills)."""
        import io as _io
        import re as _re

        try:
            from .. import native
        except ImportError:
            native = None
        if native is None or not native.available():
            return self.add_spectra_stream(_io.StringIO(buf.decode()))
        m = _re.search(rb"(?m)^([0-9a-fA-F]+)\t", buf)
        if m is None:  # headers only (or empty)
            n = self.add_spectra_stream(_io.StringIO(buf.decode()))
            last = buf.rstrip(b"\n").rfind(b"\t")
            if last >= 0 and (last == 0 or buf[last - 1 : last] == b"\n"):
                label = buf[last + 1 :].split(b"\n")[0].decode()
                self._last_ingest_col = self._col_idx.get(
                    strip_external_quotes_and_check(label)
                )
            return n
        width = len(m.group(1))
        kinds, codes, counts, labels, consumed = native.spectra_parse(buf)
        if buf[consumed:].strip():
            raise spectra_io.SpectraFormatError("truncated spectra buffer")
        if len(kinds) == 0:
            return 0
        if kinds[0] != 1:
            if not (allow_continuation and self._last_ingest_col is not None):
                raise spectra_io.SpectraFormatError("header expected")
        header_pos = np.nonzero(kinds == 1)[0]
        segments = []
        if kinds[0] != 1:
            first_end = int(header_pos[0]) if len(header_pos) else len(kinds)
            segments.append((self._last_ingest_col, 0, first_end))
        bounds = np.append(header_pos, len(kinds))
        for hi, h in enumerate(header_pos):
            label = strip_external_quotes_and_check(labels[int(h)])
            col = self._ensure_col(label)
            segments.append((col, int(h) + 1, int(bounds[hi + 1])))
        for col, lo, hi_end in segments:
            if hi_end > lo:
                rows = self._codes_to_rows(codes[lo:hi_end], width)
                acc = np.bincount(
                    rows, weights=counts[lo:hi_end], minlength=self.n_rows
                )
                self.counts[:, col] += acc.astype(self.counts.dtype)
            self._last_ingest_col = col
        return len(header_pos)

    def add_files(self, prefixes: Sequence[str]) -> int:
        from ..utils.progress import Progress

        n = 0
        chunk_size = 64 << 20
        for prefix in prefixes:
            path = spectra_io.spectra_filename(prefix)
            prog = Progress(
                "KMerDB.add_files", "Reading spectra from '%s'" % path
            )
            try:
                from .. import native as _native

                use_native = _native.available()
            except ImportError:
                use_native = False
            if use_native:
                from ..utils.naming import open_in_bin

                f = open_in_bin(path)
                try:
                    carry = b""
                    first = True
                    while True:
                        chunk = f.read(chunk_size)
                        if not chunk:
                            if carry.strip():
                                n += self.add_spectra_bytes(
                                    carry, allow_continuation=not first
                                )
                            break
                        buf = carry + chunk
                        # keep the trailing incomplete line for the refill
                        cut = buf.rfind(b"\n") + 1
                        carry = buf[cut:]
                        head = buf[:cut]
                        if head.strip():
                            n += self.add_spectra_bytes(
                                head, allow_continuation=not first
                            )
                            first = False
                        prog.update(n)
                finally:
                    close_if_owned(f, path)
            else:
                f = open_in(path)
                try:
                    n += self.add_spectra_stream(f)
                finally:
                    close_if_owned(f, path)
            prog.update(n)
            prog.done("spectra.")
        return n

    def add_meta(self, fname: str) -> None:
        """TSV with header; first column = sample label (lib/KMerDB.ml:433-501)."""
        f = open_in(fname)
        try:
            header_line = f.readline()
            if not header_line:
                return
            header = [
                strip_external_quotes_and_check(x)
                for x in header_line.rstrip("\n").split("\t")
            ]
            for name in header[1:]:
                if name not in self.meta_names:
                    self.meta_names.append(name)
                    for m in self.meta:
                        m.append("")
            meta_indices = [self.meta_names.index(n) for n in header[1:]]
            line_num = 1
            for line in f:
                line_num += 1
                parts = [
                    strip_external_quotes_and_check(x)
                    for x in line.rstrip("\n").split("\t")
                ]
                if len(parts) != len(header):
                    raise WrongNumberOfColumns(line_num, len(parts), len(header))
                col = self._ensure_col(parts[0])
                for v, mi in zip(parts[1:], meta_indices):
                    self.meta[col][mi] = v
        finally:
            close_if_owned(f, fname)

    # ---------------- selection ----------------

    def selected_from_regexps(
        self, regexps: Sequence[Tuple[str, str]]
    ) -> set[str]:
        """AND-conjunction of ``field~regexp`` matchers over columns
        (lib/KMerDB.ml:577-611).  Empty field matches the label.  Regexps are
        anchored at the start (OCaml ``Str.string_match`` semantics); Python
        ``re`` syntax is a documented deviation from OCaml ``Str``."""
        compiled = [(what, re.compile(rx)) for what, rx in regexps]
        out = set()
        for ci, col_name in enumerate(self.col_names):
            ok = True
            for what, rx in compiled:
                if what == "":
                    subject = col_name
                else:
                    try:
                        mi = self.meta_names.index(what)
                    except ValueError:
                        ok = False
                        break
                    subject = self.meta[ci][mi]
                if rx.match(subject) is None:
                    ok = False
                    break
            if ok:
                out.add(col_name)
        return out

    def selected_negate(self, selection: set[str]) -> set[str]:
        return set(self.col_names) - selection

    def remove_selected(self, selection: set[str]) -> "CounterDB":
        keep = [i for i, n in enumerate(self.col_names) if n not in selection]
        return CounterDB(
            row_names=list(self.row_names),
            col_names=[self.col_names[i] for i in keep],
            meta_names=list(self.meta_names),
            meta=[list(self.meta[i]) for i in keep],
            counts=self.counts[:, keep],
        )

    # ---------------- combination ----------------

    def add_combined_selected(
        self, new_label: str, selection: set[str], criterion: str = "mean"
    ) -> None:
        """Combine selected spectra into one (lib/KMerDB.ml:628-736).

        Each selected column is normalized by its sum, rescaled by the
        maximum norm, then rows are combined with a rescaled mean (=sum) or
        median*n; the result is truncated to int32.  Metadata fields keep the
        value iff it is shared by every selected column."""
        if criterion not in ("mean", "median"):
            raise UnknownCombinationCriterion(criterion)
        col_sums = self.counts.astype(np.float64).sum(axis=0)
        found = [self._col_idx[l] for l in sorted(selection) if l in self._col_idx]
        max_norm = max((col_sums[c] for c in found), default=0.0)
        ncols_found = len(found)
        col = self._ensure_col(new_label)
        if ncols_found:
            sub = self.counts[:, found].astype(np.float64)
            norms = col_sums[found]
            ok = norms > 0
            scaled = np.where(
                ok[None, :], sub * (max_norm / np.where(ok, norms, 1.0))[None, :], 0.0
            )
            if criterion == "mean":
                combined = scaled[:, ok].sum(axis=1)
            else:
                vals = scaled[:, ok]
                if vals.shape[1] == 0:
                    combined = np.zeros(self.n_rows)
                else:
                    combined = upper_median(vals, axis=1) * ncols_found
            self.counts[:, col] = combined.astype(np.int32)  # trunc, ref :701
        # metadata intersection (lib/KMerDB.ml:714-735)
        if self.n_meta > 0:
            for mi in range(self.n_meta):
                vals = {self.meta[c][mi] for c in found}
                self.meta[col][mi] = vals.pop() if len(vals) == 1 else ""

    def indicator_vector(self, classes_label: str):
        """(n_classes, ind_to_class, per-sample class index);
        lib/KMerDB.ml:738-763 — class ids in order of first appearance."""
        try:
            mi = self.meta_names.index(classes_label)
        except ValueError:
            raise ClassesLabelNotFound(classes_label) from None
        class_to_ind: Dict[str, int] = {}
        ind_to_class: List[str] = []
        res = np.zeros(self.n_cols, dtype=np.int64)
        for ci in range(self.n_cols):
            cl = self.meta[ci][mi]
            if cl not in class_to_ind:
                class_to_ind[cl] = len(ind_to_class)
                ind_to_class.append(cl)
            res[ci] = class_to_ind[cl]
        return len(ind_to_class), ind_to_class, res

    def split_spectra(self, classes_label: str, criterion: str = "mean") -> "CounterDB":
        """Group columns by class, combine each group, drop originals
        (lib/KMerDB.ml:787-810)."""
        _, ind_to_class, ind = self.indicator_vector(classes_label)
        original = set(self.col_names)
        for class_ind, class_name in enumerate(ind_to_class):
            if class_name in self._col_idx:
                raise ClassLabelIsAlsoSpectrumName(class_name)
            members = {
                self.col_names[i] for i in range(len(ind)) if ind[i] == class_ind
            }
            self.add_combined_selected(class_name, members, criterion)
        return self.remove_selected(original)

    # ---------------- export ----------------

    def _export_rows_cols(self, filter: TableFilter, stats: StatsTable):
        """Tuple-list form of the kept rows/cols (public transformed* API)."""
        ri, ci = self._export_row_col_idx(filter, stats)
        rows = [(self.row_names[i], int(i)) for i in ri]
        cols = [(self.col_names[i], int(i)) for i in ci]
        return rows, cols

    def _export_row_col_idx(self, filter: TableFilter, stats: StatsTable):
        """Kept row/col indices as int64 arrays — the streaming writers use
        these directly; (name, idx) tuple lists at multi-million-row scale
        cost ~100 B/row of pure overhead."""
        ri = (
            np.arange(self.n_rows, dtype=np.int64)
            if filter.print_zero_rows
            else np.nonzero(stats.row_sum > 0.0)[0].astype(np.int64)
        )
        if filter.filter_columns:
            ci = np.array(
                [
                    i
                    for i, n in enumerate(self.col_names)
                    if n not in filter.filter_columns
                ],
                dtype=np.int64,
            )
        else:
            ci = np.arange(self.n_cols, dtype=np.int64)
        return ri, ci

    def _col_subset_stats(
        self, stats: StatsTable, ci: np.ndarray
    ) -> StatsTable:
        """Column-subset view of the stats (apply_transform only reads the
        column arrays; the row arrays ride along unchanged)."""
        return StatsTable(
            stats.col_non_zero[ci], stats.col_min[ci], stats.col_max[ci],
            stats.col_sum[ci], stats.col_sum_log[ci],
            stats.row_non_zero, stats.row_min, stats.row_max,
            stats.row_sum, stats.row_sum_log,
        )

    def _transform_stats(self, filter: TableFilter):
        """(stats, ri, ci, column-subset stats for apply_transform)."""
        stats = stats_table(self.counts, filter.transform)
        ri, ci = self._export_row_col_idx(filter, stats)
        return stats, ri, ci, self._col_subset_stats(stats, ci)

    def transformed_blocks(
        self, filter: TableFilter, block_bytes: int | None = None
    ):
        """Stream the transformed export row-blocked: yields
        ``(ri_chunk, ci, block)`` with ``block`` of shape
        ``[len(ri_chunk), len(ci)]`` (index arrays into row/col_names).
        Peak extra memory is O(block x n_cols) — the reference streams this
        chunk-parallel (lib/KMerDB.ml:1004-1171); materializing the full
        transformed float64 matrix caps DB size far below the reference's
        2 GB counters (README.md:1029).
        """
        from ..utils.progress import Progress
        from .transforms import export_block_rows

        _stats, ri, ci, stats_sub = self._transform_stats(filter)
        R = export_block_rows(max(1, len(ci)), block_bytes)
        prog = Progress(
            "KMerDB.transformed_blocks", "Transforming rows", len(ri)
        )
        for r0 in range(0, len(ri), R):
            prog.update(r0)
            ridx = ri[r0 : r0 + R]
            blk = (
                apply_transform(
                    self.counts[ridx][:, ci], filter.transform, stats_sub
                )
                if len(ridx) and len(ci)
                else np.zeros((len(ridx), len(ci)))
            )
            yield ridx, ci, blk
        prog.done()

    def transformed(
        self, filter: TableFilter, block_bytes: int | None = None
    ) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]], np.ndarray]:
        """(rows, cols, transformed submatrix [len(rows), len(cols)]).

        Fills the output row-block by row-block (transformed_blocks), so
        peak memory is the output itself plus one block — not a full
        transformed copy of the untrimmed table plus a fancy-indexed copy.
        """
        stats = stats_table(self.counts, filter.transform)
        rows, cols = self._export_rows_cols(filter, stats)
        sub = np.empty((len(rows), len(cols)))
        off = 0
        for ridx, _, blk in self.transformed_blocks(filter, block_bytes):
            sub[off : off + len(ridx)] = blk
            off += len(ridx)
        return rows, cols, sub

    def transformed_counts(
        self, filter: TableFilter
    ) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]], np.ndarray]:
        """Like :meth:`transformed`, but when the transform is the identity
        on non-negative integer counts (``power`` with threshold=1 power=1 —
        the KPopTwist driver default) the submatrix comes back as the raw
        int32 counts subset with NO float64 materialization: half the peak
        memory, and the sharded CA's compact wire (parallel/sharded.py)
        casts int32 straight to its u8/u16 upload dtype."""
        tr = filter.transform
        if (
            tr.normalized_which == "power"
            and tr.power == 1.0
            and tr.threshold == 1.0
        ):
            stats = stats_table(self.counts, tr)
            rows, cols = self._export_rows_cols(filter, stats)
            ri = np.array([i for _, i in rows], dtype=np.int64)
            ci = np.array([i for _, i in cols], dtype=np.int64)
            sub = (
                self.counts[np.ix_(ri, ci)]
                if len(rows) and len(cols)
                else np.zeros((len(rows), len(cols)), dtype=np.int32)
            )
            return rows, cols, sub
        return self.transformed(filter)

    def _transformed_col_block(
        self,
        filter: TableFilter,
        ri: np.ndarray,
        ci_chunk: np.ndarray,
        stats: StatsTable,
    ) -> np.ndarray:
        """Transformed [len(ri), len(ci_chunk)] slab for a chunk of columns
        (the transposed-table / spectra writers stream over output lines =
        original columns)."""
        if not len(ri) or not len(ci_chunk):
            return np.zeros((len(ri), len(ci_chunk)))
        return apply_transform(
            self.counts[ri][:, ci_chunk],
            filter.transform,
            self._col_subset_stats(stats, ci_chunk),
        )

    def _col_block_size(self, n_rows_out: int, block_bytes: int | None) -> int:
        if block_bytes is None:
            import os as _os

            block_bytes = int(
                _os.environ.get("KPOP_EXPORT_BLOCK_BYTES", 256 << 20)
            )
        return max(1, block_bytes // max(1, n_rows_out * 8 * 4))

    def to_table(
        self,
        prefix: str,
        filter: TableFilter | None = None,
        block_bytes: int | None = None,
    ) -> None:
        """Write the DB as a (possibly transposed/filtered/transformed) TSV
        (lib/KMerDB.ml:1004-1171).  Names are unquoted in this format.
        Streams blocked over output lines (k-mer rows, or original columns
        when transposed) like the reference's chunk-parallel writer."""
        filter = filter or TableFilter()
        path = with_ext(prefix, COUNTER_TABLE_EXT)
        meta_rows = (
            [(n, i) for i, n in enumerate(self.meta_names)]
            if filter.print_metadata
            else []
        )
        fmt = "%.{}g".format(filter.precision)
        stats, ri, ci, stats_sub = self._transform_stats(filter)
        row_names, col_names = self.row_names, self.col_names
        f = open_out(path)
        try:
            if len(meta_rows) + len(ri) == 0:
                return
            if filter.transpose:
                if filter.print_col_names:
                    names = [n for n, _ in meta_rows] + [
                        row_names[i] for i in ri
                    ]
                    lead = "\t" if filter.print_row_names else ""
                    f.write(lead + "\t".join(names) + "\n")
                fmt_native = _native_formatter()
                C = self._col_block_size(max(1, len(ri)), block_bytes)
                with_prefix = bool(filter.print_row_names or meta_rows)
                from ..utils.progress import Progress

                prog = Progress(
                    "KMerDB.to_table", "Writing transposed table", len(ci)
                )
                for c0 in range(0, len(ci), C):
                    prog.update(c0)
                    ci_chunk = ci[c0 : c0 + C]
                    slab = self._transformed_col_block(
                        filter, ri, ci_chunk, stats
                    )
                    if fmt_native is not None:
                        prefixes = None
                        if with_prefix:
                            prefixes = []
                            for col_idx in ci_chunk:
                                parts = (
                                    [col_names[col_idx]]
                                    if filter.print_row_names
                                    else []
                                )
                                parts += [
                                    self.meta[col_idx][mi]
                                    for _, mi in meta_rows
                                ]
                                prefixes.append("\t".join(parts))
                        f.write(
                            fmt_native.format_tsv(
                                slab.T, filter.precision, prefixes
                            ).decode("utf-8", "surrogateescape")
                        )
                        continue
                    for j, col_idx in enumerate(ci_chunk):
                        parts = []
                        if filter.print_row_names:
                            parts.append(col_names[col_idx])
                        parts += [
                            self.meta[col_idx][mi] for _, mi in meta_rows
                        ]
                        parts += [fmt % v for v in slab[:, j]]
                        f.write("\t".join(parts) + "\n")
                prog.done("lines.")
            else:
                from .transforms import export_block_rows

                if filter.print_col_names:
                    lead = "\t" if filter.print_row_names else ""
                    f.write(
                        lead + "\t".join(col_names[i] for i in ci) + "\n"
                    )
                for meta_name, mi in meta_rows:
                    parts = [meta_name] if filter.print_row_names else []
                    parts += [self.meta[c][mi] for c in ci]
                    f.write("\t".join(parts) + "\n")
                fmt_native = _native_formatter()
                R = export_block_rows(max(1, len(ci)), block_bytes)
                from ..utils.progress import Progress

                prog = Progress(
                    "KMerDB.to_table", "Writing table", len(ri)
                )
                for r0 in range(0, len(ri), R):
                    prog.update(r0)
                    ridx = ri[r0 : r0 + R]
                    blk = (
                        apply_transform(
                            self.counts[ridx][:, ci],
                            filter.transform,
                            stats_sub,
                        )
                        if len(ridx) and len(ci)
                        else np.zeros((len(ridx), len(ci)))
                    )
                    if fmt_native is not None:
                        prefixes = (
                            [row_names[i] for i in ridx]
                            if filter.print_row_names
                            else None
                        )
                        f.write(
                            fmt_native.format_tsv(
                                blk, filter.precision, prefixes
                            ).decode("utf-8", "surrogateescape")
                        )
                        continue
                    for i, row_i in enumerate(ridx):
                        parts = (
                            [row_names[row_i]]
                            if filter.print_row_names
                            else []
                        )
                        parts += [fmt % v for v in blk[i, :]]
                        f.write("\t".join(parts) + "\n")
                prog.done("lines.")
        finally:
            close_if_owned(f, path)

    def to_spectra(
        self,
        prefix: str,
        filter: TableFilter | None = None,
        block_bytes: int | None = None,
    ) -> None:
        """Write as text spectra, dropping zero entries (lib/KMerDB.ml:1172-1239).
        Streams blocked over spectra (original columns)."""
        filter = filter or TableFilter()
        path = spectra_io.spectra_filename(prefix)
        stats, ri, ci, _ = self._transform_stats(filter)
        fmt = "%.{}g".format(filter.precision)
        row_names, col_names = self.row_names, self.col_names
        f = open_out(path)
        try:
            fmt_native = _native_formatter()
            names_blob = (
                fmt_native._names_blob([row_names[i] for i in ri])
                if fmt_native is not None and len(ri)
                else None
            )
            C = self._col_block_size(max(1, len(ri)), block_bytes)
            from ..utils.progress import Progress

            prog = Progress(
                "KMerDB.to_spectra", "Writing spectra", len(ci)
            )
            for c0 in range(0, len(ci), C):
                prog.update(c0)
                ci_chunk = ci[c0 : c0 + C]
                slab = self._transformed_col_block(
                    filter, ri, ci_chunk, stats
                )
                for j, col_idx in enumerate(ci_chunk):
                    f.write("\t%s\n" % col_names[col_idx])
                    vals = slab[:, j]
                    if names_blob is not None:
                        f.write(
                            fmt_native.format_spectra_col(
                                vals, filter.precision, *names_blob
                            ).decode("utf-8", "surrogateescape")
                        )
                        continue
                    for i in np.nonzero(vals > 0)[0]:
                        f.write(
                            "%s\t%s\n" % (row_names[ri[i]], fmt % vals[i])
                        )
            prog.done("spectra.")
        finally:
            close_if_owned(f, path)

    def submatrix_normalized(
        self, selection: set[str], normalise: bool = True
    ) -> NamedMatrix:
        """Selected columns as rows of a float matrix, each divided by its
        column sum (lib/KMerDB.ml:1246-1271)."""
        idxs = [i for i, n in enumerate(self.col_names) if n in selection]
        sub = self.counts[:, idxs].astype(np.float64).T  # [n_sel, n_kmers]
        if normalise:
            norms = sub.sum(axis=1, keepdims=True)
            norms = np.where(norms == 0.0, 1.0, norms)
            sub = sub / norms
        return NamedMatrix(
            [self.col_names[i] for i in idxs], list(self.row_names), sub
        )

    # ---------------- distillation ----------------

    def distill_kmers(
        self, classes_label: str, block_bytes: int | None = None
    ) -> NamedMatrix:
        """Per-k-mer discriminative-power analysis (lib/KMerDB.ml:816-976).

        For every k-mer, |normalized count differences| over all sample pairs
        are pooled into per-class-pair statistics (mean, sample variance,
        sample CoV); their across-class-pairs means/medians, plus residuals
        of the off-class vs on-class linear fits, form the 18-column
        ``KPopDistill`` matrix (rows = k-mers after transposition).

        Streams in k-mer row blocks like the reference's chunk-parallel
        pipeline (lib/KMerDB.ml:850-897): peak extra memory is
        O(block_rows x n_pairs), never the full [n_kmers, n_pairs]
        |difference| matrix — at the reference's own flagship scale
        (16.7M k-mers, 1,000 samples => 499,500 pairs) the dense form
        would be ~10^4 GB.  The pair axis is pre-sorted by class-pair
        bucket so each block reduces with one ``np.add.reduceat``; the
        variance uses the same two-pass form as ``np.var(ddof=1)``.
        ``block_bytes`` (default 256 MB, env ``KPOP_DISTILL_BLOCK_BYTES``)
        bounds the per-block temporaries.
        """
        n_classes, _, ind = self.indicator_vector(classes_label)
        n_samples = self.n_cols
        if n_classes == 1 or n_classes == n_samples:
            raise InvalidNumberOfClasses(n_classes)
        col_sums = self.counts.sum(axis=0, dtype=np.int64).astype(np.float64)
        col_sums = np.where(col_sums == 0.0, 1.0, col_sums)
        iu, ju = np.triu_indices(n_samples, k=1)
        ci, cj = ind[iu], ind[ju]
        a = np.minimum(ci, cj)
        b = np.maximum(ci, cj)
        pair_class = a * n_classes + b  # class-pair bucket per sample pair
        # sort the pair axis by bucket once; blocks then reduce per bucket
        # with a single segmented sum instead of per-bucket gathers
        order = np.argsort(pair_class, kind="stable")
        iu_s, ju_s = iu[order], ju[order]
        uniq, starts = np.unique(pair_class[order], return_index=True)
        n_pairs = len(order)
        n_b = len(uniq)
        per_bucket = np.diff(np.append(starts, n_pairs))
        bucket_of_pair = np.repeat(np.arange(n_b), per_bucket)
        nb_f = per_bucket.astype(np.float64)

        nk = self.n_rows
        if block_bytes is None:
            import os as _os

            block_bytes = int(
                _os.environ.get("KPOP_DISTILL_BLOCK_BYTES", 256 << 20)
            )
        rows_per_block = max(
            1, min(nk, block_bytes // max(1, n_pairs * 8 * 3))
        )
        sum1 = np.zeros((nk, n_b))
        sumsq = np.zeros((nk, n_b))
        from ..utils.progress import Progress

        prog = Progress("KMerDB.distill_kmers", "Distilling k-mers", nk)
        for r0 in range(0, nk, rows_per_block):
            prog.update(r0)
            r1 = min(r0 + rows_per_block, nk)
            blk = self.counts[r0:r1].astype(np.float64) / col_sums[None, :]
            d = blk[:, iu_s]
            d -= blk[:, ju_s]
            np.abs(d, out=d)
            s1 = np.add.reduceat(d, starts, axis=1)
            sum1[r0:r1] = s1
            # second pass: centered squares (numerically the np.var form)
            d -= (s1 / nb_f[None, :])[:, bucket_of_pair]
            d *= d
            sumsq[r0:r1] = np.add.reduceat(d, starts, axis=1)
        prog.done()

        mean_b = sum1 / nb_f[None, :]
        var_b = np.where(
            nb_f[None, :] >= 2.0,
            sumsq / np.maximum(nb_f - 1.0, 1.0)[None, :],
            0.0,
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            cov_b = np.where(mean_b > 0, np.sqrt(var_b) / mean_b, 0.0)
        col_of_bucket = {int(u): i for i, u in enumerate(uniq)}
        zeros = np.zeros(nk)

        def _bucket_stats(key: int):
            i = col_of_bucket.get(key)
            if i is None:  # no sample pairs (singleton class on-diagonal)
                return zeros, zeros, zeros
            return mean_b[:, i], var_b[:, i], cov_b[:, i]

        on_means, on_vars, on_covs = [], [], []
        off_means, off_vars, off_covs = [], [], []
        for a_c in range(n_classes):
            m, v, cv = _bucket_stats(a_c * n_classes + a_c)
            on_means.append(m)
            on_vars.append(v)
            on_covs.append(cv)
            for b_c in range(a_c + 1, n_classes):
                m, v, cv = _bucket_stats(a_c * n_classes + b_c)
                off_means.append(m)
                off_vars.append(v)
                off_covs.append(cv)

        def mm(values: List[np.ndarray]):
            arr = np.stack(values, axis=1)  # [k, n_class_pairs]
            return arr.mean(axis=1), upper_median(arr, axis=1)

        avg_on_mean, avg_on_med = mm(on_means)
        avg_off_mean, avg_off_med = mm(off_means)
        var_on_mean, var_on_med = mm(on_vars)
        var_off_mean, var_off_med = mm(off_vars)
        cov_on_mean, cov_on_med = mm(on_covs)
        cov_off_mean, cov_off_med = mm(off_covs)

        def residuals(xv: np.ndarray, yv: np.ndarray):
            # least-squares fit y = a + b x; residuals y - (a + b x)
            xm, ym = xv.mean(), yv.mean()
            den = ((xv - xm) ** 2).sum()
            slope = ((xv - xm) * (yv - ym)).sum() / den if den > 0 else 0.0
            inter = ym - slope * xm
            return yv - (inter + slope * xv)

        row_data = [
            ("InnerAvgMean", avg_on_mean),
            ("OuterAvgMean", avg_off_mean),
            ("ResidualAvgMean", residuals(avg_on_mean, avg_off_mean)),
            ("InnerAvgMedian", avg_on_med),
            ("OuterAvgMedian", avg_off_med),
            ("ResidualAvgMedian", residuals(avg_on_med, avg_off_med)),
            ("InnerVarMean", var_on_mean),
            ("OuterVarMean", var_off_mean),
            ("ResidualVarMean", residuals(var_on_mean, var_off_mean)),
            ("InnerVarMedian", var_on_med),
            ("OuterVarMedian", var_off_med),
            ("ResidualVarMedian", residuals(var_on_med, var_off_med)),
            ("InnerCOVMean", cov_on_mean),
            ("OuterCOVMean", cov_off_mean),
            ("ResidualCOVMean", residuals(cov_on_mean, cov_off_mean)),
            ("InnerCOVMedian", cov_on_med),
            ("OuterCOVMedian", cov_off_med),
            ("ResidualCOVMedian", residuals(cov_on_med, cov_off_med)),
        ]
        return NamedMatrix(
            [n for n, _ in row_data],
            list(self.row_names),
            np.stack([d for _, d in row_data], axis=0),
        )

    def distill_to_file(self, classes_label: str, prefix: str, precision: int = 15):
        """Write the transposed distill summary (k-mers as rows), matching
        ``Matrix.to_file (Matrix.transpose summary)`` (lib/KMerDB.ml:976)."""
        m = self.distill_kmers(classes_label).transpose()
        path = MatrixType.DISTILL.table_filename(prefix)
        f = open_out(path)
        try:
            m.write_text(f, precision=precision)
        finally:
            close_if_owned(f, path)

    # ---------------- binary I/O ----------------

    def to_binary(self, prefix: str) -> None:
        path = with_ext(prefix, COUNTER_BIN_EXT)
        f = open_out_bin(path)
        try:
            framed.write_header(f, BINARY_TAG)
            framed.write_strings(f, "row_names", self.row_names)
            framed.write_strings(f, "col_names", self.col_names)
            framed.write_strings(f, "meta_names", self.meta_names)
            flat_meta = [v for row in self.meta for v in row]
            framed.write_strings(f, "meta", flat_meta)
            framed.write_array(f, "counts", self.counts.astype(np.int32))
            framed.write_terminator(f)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_binary(cls, prefix: str) -> "CounterDB":
        path = with_ext(prefix, COUNTER_BIN_EXT)
        f = open_in_bin(path)
        try:
            framed.read_header(f, expect_tag=BINARY_TAG)
            frames = framed.read_frames(f)
        finally:
            close_if_owned(f, path)
        row_names = framed.strings_of_frames(frames, "row_names")
        col_names = framed.strings_of_frames(frames, "col_names")
        meta_names = framed.strings_of_frames(frames, "meta_names")
        flat_meta = framed.strings_of_frames(frames, "meta")
        nm = len(meta_names)
        meta = [
            flat_meta[i * nm : (i + 1) * nm] if nm else []
            for i in range(len(col_names))
        ]
        return cls(
            row_names=row_names,
            col_names=col_names,
            meta_names=meta_names,
            meta=meta,
            counts=frames["counts"].copy(),
        )


def upper_median(a: np.ndarray, axis: int) -> np.ndarray:
    """Median as the element at 0-based position n//2 of the sorted values —
    the reference's convention throughout (e.g. lib/Matrix.ml:640-650)."""
    s = np.sort(a, axis=axis)
    n = a.shape[axis]
    return np.take(s, n // 2, axis=axis)
