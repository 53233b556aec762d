"""Distances, metrics and distance summaries.

Exact re-implementations of the reference's ``Space.Distance`` /
``Space.Distance.Metric`` (lib/Space.ml:21-230) and the distance machinery of
``Matrix.Base`` (lib/Matrix.ml:24-267) plus the per-query summarization
(lib/Matrix.ml:632-766) — vectorized over whole matrices instead of
per-element fork-parallel loops.  The numpy implementations here are the
float64 golden path used by the CLI; the batched device kernels in
:mod:`kpop_tpu.ops.pairwise` are tested against them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .matrix import IncompatibleGeometries, NamedMatrix


class UnknownDistance(ValueError):
    pass


class UnknownMetric(ValueError):
    pass


class NegativePower(ValueError):
    pass


class InvalidThreshold(ValueError):
    pass


# ---------------- geometry-mismatch mode ----------------
# lib/Space.ml:46-51,144-149: on incompatible vector geometries the library
# either raises (Fail, the default) or yields +infinity (Infinity).  Dense
# matrices make the mismatch a whole-matrix property, so Infinity mode turns
# the rectangular result into an all-inf matrix instead of raising.

_MODE = "fail"


def set_mode(mode: str) -> None:
    if mode not in ("fail", "infinity"):
        raise ValueError(f"unknown distance mode {mode!r}")
    global _MODE
    _MODE = mode


def get_mode() -> str:
    return _MODE


def _check_geometry(cols1, cols2) -> bool:
    """True if compatible; raises or signals all-inf according to the mode."""
    if list(cols1) == list(cols2):
        return True
    if _MODE == "fail":
        raise IncompatibleGeometries(cols1, cols2)
    return False


# ---------------- distance functions ----------------


@dataclass(frozen=True)
class Distance:
    """'euclidean' | 'cosine' | 'minkowski(p)'  (lib/Space.ml:140-143).

    Cosine is (euclidean^2)/2; minkowski's parameter is the power.
    """

    kind: str = "euclidean"
    power: float = 2.0

    @classmethod
    def of_string(cls, s: str) -> "Distance":
        if s == "euclidean":
            return cls("euclidean")
        if s == "cosine":
            return cls("cosine")
        m = re.fullmatch(r"minkowski\(([^)]*)\)", s)
        if m:
            try:
                p = float(m.group(1))
            except ValueError:
                raise UnknownDistance(s) from None
            if p < 0.0:
                raise NegativePower(p)
            return cls("minkowski", p)
        raise UnknownDistance(s)

    def to_string(self) -> str:
        if self.kind == "minkowski":
            return "minkowski(%.15g)" % self.power
        return self.kind

    # unscaled accumulation + final scaling (lib/Space.ml:150-181)

    def _accum(self, diff: np.ndarray, metric: np.ndarray, axis=-1) -> np.ndarray:
        if self.kind in ("euclidean", "cosine"):
            return (diff * diff * metric).sum(axis=axis)
        return (np.abs(diff) ** self.power * metric).sum(axis=axis)

    def _scale(self, acc: np.ndarray) -> np.ndarray:
        if self.kind == "euclidean":
            return np.sqrt(acc)
        if self.kind == "cosine":
            return acc / 2.0
        with np.errstate(divide="ignore"):
            return acc ** (1.0 / self.power)

    def compute_norm(self, metric: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Row norms of ``v`` ([..., d]) under this distance and metric."""
        return self._scale(self._accum(v, metric))

    def compute_rowwise(
        self,
        metric: np.ndarray,
        m1: np.ndarray,
        m2: np.ndarray,
        n1: np.ndarray | None = None,
        n2: np.ndarray | None = None,
    ) -> np.ndarray:
        """All-pairs distances: result[j, i] = d(m1[i]/n1[i], m2[j]/n2[j]).

        Matches ``Base.get_distance_rowwise`` (lib/Matrix.ml:191-266)
        including the output orientation (rows = m2, cols = m1).
        """
        a = m1 if n1 is None else m1 / n1[:, None]
        b = m2 if n2 is None else m2 / n2[:, None]
        if self.kind in ("euclidean", "cosine"):
            am = a * metric[None, :]
            cross = b @ am.T  # [r2, r1]
            na = (a * am).sum(axis=1)  # [r1]
            nb = (b * b * metric[None, :]).sum(axis=1)  # [r2]
            acc = np.maximum(na[None, :] + nb[:, None] - 2.0 * cross, 0.0)
            return self._scale(acc)
        # general minkowski: blocked broadcast
        r1, r2 = a.shape[0], b.shape[0]
        out = np.zeros((r2, r1))
        block = max(1, int(4e7 // max(1, r1 * a.shape[1])))
        for lo in range(0, r2, block):
            hi = min(lo + block, r2)
            diff = a[None, :, :] - b[lo:hi, None, :]
            out[lo:hi] = self._accum(diff, metric[None, None, :])
        return self._scale(out)


def normalizations(
    distance: Distance, metric: np.ndarray, m: np.ndarray
) -> np.ndarray:
    """Row norms with 0 -> 1 (``get_normalizations``, lib/Matrix.ml:42-76)."""
    norms = distance.compute_norm(metric, m)
    return np.where(norms == 0.0, 1.0, norms)


# ---------------- metric derivation ----------------


@dataclass(frozen=True)
class Metric:
    """'flat' | 'powers(p_int, threshold, p_ext)' (lib/Space.ml:79-137)."""

    kind: str = "powers"
    power_int: float = 1.0
    threshold: float = 1.0
    power_ext: float = 2.0

    @classmethod
    def of_string(cls, s: str) -> "Metric":
        if s == "flat":
            return cls("flat")
        m = re.fullmatch(r"powers\(([^,]*),([^,]*),([^)]*)\)", s)
        if m:
            try:
                pi, thr, pe = (float(g) for g in m.groups())
            except ValueError:
                raise UnknownMetric(s) from None
            if pi < 0.0:
                raise NegativePower(pi)
            if not (0.0 <= thr <= 1.0):
                raise InvalidThreshold(thr)
            if pe < 0.0:
                raise NegativePower(pe)
            return cls("powers", pi, thr, pe)
        raise UnknownMetric(s)

    def to_string(self) -> str:
        if self.kind == "flat":
            return "flat"
        return "powers(%.15g,%.15g,%.15g)" % (
            self.power_int,
            self.threshold,
            self.power_ext,
        )

    def compute(self, m: np.ndarray) -> np.ndarray:
        """Derive per-dimension weights from an inertia vector.

        powers: ``x = m^p_int``; keep the leading elements until their
        cumulative mass reaches ``threshold`` of the total (elements are
        assumed sorted decreasing, as inertia is); raise to ``p_ext``;
        normalize to unit L1 mass (lib/Space.ml:96-105).
        """
        m = np.asarray(m, dtype=np.float64)
        if self.kind == "flat":
            n = len(m)
            return np.full(n, 1.0 / n) if n else m
        x = np.abs(m) ** self.power_int
        total = x.sum()
        if total > 0.0:
            cum_before = np.concatenate([[0.0], np.cumsum(x)[:-1]])
            x = np.where(cum_before < self.threshold * total, x, 0.0)
        x = x**self.power_ext
        total = x.sum()
        return x / total if total > 0.0 else x


# ---------------- embeddings ----------------


def embeddings(
    distance: Distance,
    metric: np.ndarray,
    m: NamedMatrix,
    normalize: bool = True,
) -> NamedMatrix:
    """Principal-coordinate embeddings from twisted vectors
    (``Base.get_embeddings``, lib/Matrix.ml:78-128): scale columns by
    metric^(1/p), optionally renormalize each row to unit norm."""
    d = len(metric)
    if m.n_cols != d:
        raise IncompatibleGeometries(m.col_names, d)
    inv_power = (
        0.5 if distance.kind in ("euclidean", "cosine") else 1.0 / distance.power
    )
    nm = metric**inv_power
    v = np.asarray(m.data, dtype=np.float64) * nm[None, :]
    if normalize:
        norms = distance.compute_norm(metric, v)
        v = np.where(norms[:, None] != 0.0, v / np.where(norms == 0, 1, norms)[:, None], v)
    return NamedMatrix(list(m.row_names), list(m.col_names), v)


# ---------------- distance matrices ----------------


def distance_rowwise(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    normalize: bool = True,
) -> NamedMatrix:
    """Rectangular all-pairs distances (rows = m2's rows, cols = m1's rows)."""
    if not _check_geometry(m1.col_names, m2.col_names):
        data = np.full((m2.n_rows, m1.n_rows), np.inf)
        return NamedMatrix(list(m2.row_names), list(m1.row_names), data)
    a = np.asarray(m1.data, dtype=np.float64)
    b = np.asarray(m2.data, dtype=np.float64)
    n1 = normalizations(distance, metric, a) if normalize else None
    n2 = normalizations(distance, metric, b) if normalize else None
    data = distance.compute_rowwise(metric, a, b, n1, n2)
    return NamedMatrix(list(m2.row_names), list(m1.row_names), data)


def distance_matrix(
    distance: Distance,
    metric: np.ndarray,
    m: NamedMatrix,
    normalize: bool = True,
) -> NamedMatrix:
    """Symmetric all-pairs distances (``Base.get_distance_matrix``)."""
    a = np.asarray(m.data, dtype=np.float64)
    n = normalizations(distance, metric, a) if normalize else None
    data = distance.compute_rowwise(metric, a, a, n, n)
    # enforce exact symmetry as the reference does by construction
    data = np.triu(data.T, 1).T + np.triu(data)
    return NamedMatrix(list(m.row_names), list(m.row_names), data)


# ---------------- summaries ----------------


def summarize_distance_row(
    req_len: int, row_name: str, row: np.ndarray, col_names: List[str]
) -> str:
    """One ``.KPopSummary.txt`` line (lib/Matrix.ml:632-690):

    ``name  mean  stddev  median  MAD`` then the >= req_len nearest targets
    (whole tie-groups included), each as ``target  dist  z-score``.
    Median/MAD use the element at position n//2 of the sorted values.
    """
    n = len(row)
    srt = np.sort(row)
    mean, stddev, median, mad = mean_std_median_mad(row, srt=srt)
    order = np.lexsort((np.arange(n), row))  # stable: by distance, then index
    eff_len = 0
    if n and req_len > 0:
        kth = srt[min(req_len, n) - 1]
        eff_len = int((row <= kth).sum())
    parts = [
        row_name,
        "%.15g" % mean,
        "%.15g" % stddev,
        "%.15g" % median,
        "%.15g" % mad,
    ]
    with np.errstate(divide="ignore", invalid="ignore"):
        for idx in order[:eff_len]:
            z = np.float64(row[idx] - mean) / np.float64(stddev)
            parts += [col_names[idx], "%.15g" % row[idx], "%.15g" % z]
    return "\t".join(parts)


def summarize_matrix(
    m: NamedMatrix, keep_at_most: int | None
) -> List[str]:
    """Summary lines for every row of a distance matrix
    (``summarize_distance``, lib/Matrix.ml:767-810)."""
    req_len = m.n_cols if keep_at_most is None else keep_at_most
    data = np.asarray(m.data, dtype=np.float64)
    return [
        summarize_distance_row(req_len, rn, data[i], m.col_names)
        for i, rn in enumerate(m.row_names)
    ]


def summarize_rowwise(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    keep_at_most: int | None = 2,
    normalize: bool = True,
    block_elements: int = int(2e7),
) -> List[str]:
    """Streaming digest of the m2-by-m1 distance matrix
    (``summarize_rowwise``, lib/Matrix.ml:691-766): one line per m2 row.

    Blocked over query (m2) rows so the full [n_queries, n_targets] matrix is
    never materialized — the reference streams the same way; peak extra
    memory is one block of at most ``block_elements`` distances.
    """
    req_len = m1.n_rows if keep_at_most is None else keep_at_most
    col_names = list(m1.row_names)
    if not _check_geometry(m1.col_names, m2.col_names):
        inf_row = np.full(m1.n_rows, np.inf)
        return [
            summarize_distance_row(req_len, rn, inf_row, col_names)
            for rn in m2.row_names
        ]
    a = np.asarray(m1.data, dtype=np.float64)
    b = np.asarray(m2.data, dtype=np.float64)
    n1 = normalizations(distance, metric, a) if normalize else None
    n_targets = max(1, a.shape[0])
    block = max(1, block_elements // n_targets)
    lines: List[str] = []
    from ..utils.progress import Progress

    prog = Progress(
        "Matrix.summarize_rowwise", "Summarizing distances", b.shape[0]
    )
    for lo in range(0, b.shape[0], block):
        prog.update(lo)
        hi = min(lo + block, b.shape[0])
        bb = b[lo:hi]
        n2b = normalizations(distance, metric, bb) if normalize else None
        dm = distance.compute_rowwise(metric, a, bb, n1, n2b)
        lines.extend(
            summarize_distance_row(req_len, m2.row_names[lo + j], dm[j], col_names)
            for j in range(hi - lo)
        )
    prog.done("queries.")
    return lines


# ---------------- typed-register wrappers ----------------
# (the reference enforces KPop matrix types at this level,
#  lib/Matrix.ml:614-630,691-699)

from .matrix import KPopMatrix, MatrixType  # noqa: E402


def get_embeddings(
    distance: Distance,
    metric: np.ndarray,
    m: KPopMatrix,
    normalize: bool = True,
) -> KPopMatrix:
    m.expect(MatrixType.TWISTED)
    return KPopMatrix(
        MatrixType.VECTORS, embeddings(distance, metric, m.matrix, normalize)
    )


def get_distance_rowwise(
    distance: Distance,
    metric: np.ndarray,
    m1: KPopMatrix,
    m2: KPopMatrix,
    normalize: bool = True,
) -> KPopMatrix:
    m1.expect(MatrixType.TWISTED)
    m2.expect(MatrixType.TWISTED)
    return KPopMatrix(
        MatrixType.DMATRIX,
        distance_rowwise(distance, metric, m1.matrix, m2.matrix, normalize),
    )


def get_distance_matrix(
    distance: Distance,
    metric: np.ndarray,
    m: KPopMatrix,
    normalize: bool = True,
) -> KPopMatrix:
    m.expect(MatrixType.TWISTED)
    return KPopMatrix(
        MatrixType.DMATRIX, distance_matrix(distance, metric, m.matrix, normalize)
    )


def summarize_rowwise_typed(
    distance: Distance,
    metric: np.ndarray,
    m1: KPopMatrix,
    m2: KPopMatrix,
    keep_at_most: int | None = 2,
    normalize: bool = True,
) -> List[str]:
    m1.expect(MatrixType.TWISTED)
    m2.expect(MatrixType.TWISTED)
    return summarize_rowwise(
        distance, metric, m1.matrix, m2.matrix, keep_at_most, normalize
    )


def summarize_dmatrix(m: KPopMatrix, keep_at_most: int | None) -> List[str]:
    m.expect(MatrixType.DMATRIX)
    return summarize_matrix(m.matrix, keep_at_most)


def mean_std_median_mad(
    row: np.ndarray, srt: np.ndarray | None = None
) -> Tuple[float, float, float, float]:
    n = len(row)
    # inf distances (--distance-mode infinity) make inf - inf = nan here on
    # purpose: the digest of an all-inf row is nan, printed as such
    with np.errstate(invalid="ignore"):
        mean = row.mean() if n else 0.0
        stddev = (
            np.sqrt(((row - mean) ** 2).sum() / (n - 1)) if n > 1 else 0.0
        )
        if srt is None:
            srt = np.sort(row)
        median = srt[n // 2] if n else 0.0
        dd = np.sort(np.abs(row - median))
        mad = dd[n // 2] if n else 0.0
    return mean, stddev, median, mad
