"""Device-accelerated distance summarization for large target sets.

The production workloads summarize 10^5-10^6 query rows against 10^3+
targets (reference README.md:1049-1073: 650K queries, ~14 h on a CPU node).
Here each query batch's distance row is computed with the matmul
expansion and digested ON DEVICE (mean, n-1 stddev, upper median, MAD,
top-(K+slack) nearest); only the tiny digests travel back to the host,
which formats them with the reference's exact tie semantics
(lib/Matrix.ml:632-690).  Rows whose tie group overflows the device top-K
slack fall back to the host float64 path (rare; exact either way).
"""

from __future__ import annotations

from functools import partial
from typing import IO

import numpy as np

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402

from ..core.matrix import NamedMatrix  # noqa: E402
from ..core.space import Distance, summarize_distance_row  # noqa: E402

TOPK_SLACK = 14
#: f32 elements budgeted for the blocked minkowski |b - a| broadcast
MINK_BUDGET_ELEMS = 32 << 20  # 128 MB


def _native_formatter() -> bool:
    """True when the C summary-line formatter is available: per-row Python
    assembly of summary lines is far slower than the device digest, and
    the native block formatter removes it."""
    try:
        from .. import native

        return native.available() and hasattr(
            native.get_lib(), "kpop_format_summary"
        )
    except Exception:  # pragma: no cover - build failure -> Python path
        return False


def _distance_block(a, b, m, kind, power):
    """[B, N] distances of normalized queries ``b`` vs targets ``a``."""
    if kind in ("euclidean", "cosine"):
        am = a * m[None, :]
        cross = jnp.dot(
            b, am.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        na2 = (am * a).sum(axis=1)
        nb2 = (b * b * m[None, :]).sum(axis=1)
        acc = jnp.maximum(nb2[:, None] + na2[None, :] - 2.0 * cross, 0.0)
        return jnp.sqrt(acc) if kind == "euclidean" else acc / 2.0
    # minkowski has no matmul expansion; the [B, chunk, D] broadcast is
    # blocked over the target axis to bound device memory at ~MINK_BUDGET_ELEMS f32
    # temporaries (the host path blocks the same way, core/space.py) —
    # at the relatedness shape [1024 x 4096 x 512] this is ~128 MB instead
    # of the ~8.6 GB of the unblocked broadcast
    B, D = b.shape
    N = a.shape[0]
    chunk = int(max(1, min(N, MINK_BUDGET_ELEMS // max(1, B * D))))
    pad = (-N) % chunk
    a_p = jnp.pad(a, ((0, pad), (0, 0)))
    a_r = a_p.reshape(-1, chunk, D)

    def one(ablk):
        diff = jnp.abs(b[:, None, :] - ablk[None, :, :])
        return ((diff**power) * m[None, None, :]).sum(axis=2)

    acc = jax.lax.map(one, a_r)  # [n_chunks, B, chunk]
    acc = jnp.moveaxis(acc, 0, 1).reshape(B, -1)[:, :N]
    return acc ** (1.0 / power)


@partial(
    jax.jit,
    static_argnames=("kind", "power", "normalize", "k_cap"),
)
def _digest_batch(
    targets,
    queries,
    metric,
    tnorms,
    kind,
    power,
    normalize,
    k_cap,
):
    a = targets  # [N, D]
    b = queries  # [B, D]
    m = metric
    if normalize:
        # norms use the distance's own scaling (lib/Space.ml:159-181):
        # euclidean sqrt(.), cosine (.)/2, minkowski (.)^(1/p)
        if kind == "euclidean":
            nb = jnp.sqrt((b * b * m[None, :]).sum(axis=1))
        elif kind == "cosine":
            nb = (b * b * m[None, :]).sum(axis=1) / 2.0
        else:
            nb = (jnp.abs(b) ** power * m[None, :]).sum(axis=1) ** (1.0 / power)
        nb = jnp.where(nb == 0.0, 1.0, nb)
        b = b / nb[:, None]
        a = a / tnorms[:, None]
    dmat = _distance_block(a, b, m, kind, power)
    B, N = dmat.shape
    mean = dmat.mean(axis=1)
    std = jnp.sqrt(((dmat - mean[:, None]) ** 2).sum(axis=1) / max(N - 1, 1))
    srt = jnp.sort(dmat, axis=1)
    h = N // 2
    median = srt[:, h]
    # MAD without a second sort: |d - median| over the ASCENDING row is the
    # merge of two sorted runs, so its upper median (rank h) is the smallest
    # half-width t whose interval [median - t, median + t] covers h + 1
    # elements — a contiguous window of srt that always contains index h
    # (srt[h] has diff 0).  MAD = min over the valid windows of the larger
    # end-point diff: one elementwise pass instead of an O(N log^2 N)
    # device sort.  Exact: every candidate IS one of the |d - median|
    # values, so this returns bit-identical f32 to sort-then-index.
    W = min(h, N - 1 - h) + 1  # window start j in [0, W)
    lo_diff = median[:, None] - srt[:, :W]
    hi_diff = srt[:, h : h + W] - median[:, None]
    mad = jnp.maximum(lo_diff, hi_diff).min(axis=1)
    k = min(k_cap, N)
    neg_top, idx = jax.lax.top_k(-dmat, k)
    stats = jnp.stack([mean, std, median, mad], axis=1)  # one download
    return stats, -neg_top, idx


_DIGEST_CACHE: dict = {}


def _compile_parallel(items, cache: dict) -> None:
    """``items``: list of (cache_key, build_fn) where build_fn() returns a
    compiled executable.  Missing entries compile concurrently in threads
    (XLA releases the GIL while compiling).  The jit dispatch cache does
    not reuse AOT executables, so callers call the compiled objects
    directly instead of the jits."""
    import threading

    missing = [(k, b) for k, b in items if k not in cache]
    if not missing:
        return
    if len(missing) == 1:
        k, b = missing[0]
        cache[k] = b()
        return
    results: dict = {}

    def run(k, b):
        try:
            results[k] = b()
        except Exception as e:  # re-raised on the main thread below
            results[k] = e

    threads = [
        threading.Thread(target=run, args=(k, b)) for k, b in missing
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, _b in missing:
        r = results[k]
        if isinstance(r, Exception):
            raise r
        cache[k] = r


def _digest_compiled(td, md, tnd, batch_sizes, statics: dict):
    """AOT-compile the digest for every batch shape concurrently and return
    {B: compiled}: the full and tail batch shapes compile in parallel
    threads."""
    D = td.shape[1]
    keys = {
        B: (td.shape, int(td.dtype.itemsize), B, D, tuple(sorted(statics.items())))
        for B in batch_sizes
    }

    def build(B):
        def _build():
            return _digest_batch.lower(
                jax.ShapeDtypeStruct(td.shape, td.dtype),
                jax.ShapeDtypeStruct((B, D), jnp.float32),
                jax.ShapeDtypeStruct(md.shape, md.dtype),
                jax.ShapeDtypeStruct(tnd.shape, tnd.dtype),
                **statics,
            ).compile()

        return _build

    _compile_parallel(
        [(keys[B], build(B)) for B in batch_sizes], cache=_DIGEST_CACHE
    )
    return {B: _DIGEST_CACHE[keys[B]] for B in batch_sizes}


def summarize_rowwise_device(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    keep_at_most: int | None,
    normalize: bool,
    out: IO[str],
    batch: int = 1024,
) -> int:
    """Write summary lines for every m2 row vs all m1 rows; returns #rows.

    Parity with :func:`core.space.summarize_rowwise` is tested: line
    layout, names, nearest-class sets and tie semantics are exact; the
    numeric fields carry f32 device error (<= ~2e-4 relative).  Ties
    overflowing the top-K slack fall back to the host per row.
    Device dispatch is pipelined two batches deep so upload + digest of
    the next batch overlap this batch's download + host formatting.
    """
    targets = np.asarray(m1.data, dtype=np.float64)
    N = targets.shape[0]
    req_len = N if keep_at_most is None else keep_at_most
    k_cap = min(N, req_len + TOPK_SLACK)
    if normalize:
        tn = distance.compute_norm(metric, targets)
        tn = np.where(tn == 0.0, 1.0, tn)
    else:
        tn = np.ones(N)
    td = jnp.asarray(targets, dtype=jnp.float32)
    md = jnp.asarray(metric, dtype=jnp.float32)
    tnd = jnp.asarray(tn, dtype=jnp.float32)
    queries = np.asarray(m2.data, dtype=np.float64)
    col_names = m1.row_names
    n_rows = 0
    host_fallbacks = 0
    from collections import deque

    from ..utils.progress import Progress

    prog = Progress(
        "Matrix.summarize_rowwise", "Summarizing distances (device)",
        queries.shape[0],
    )
    # pipeline: dispatch batch i+1 before fetching batch i, so the
    # host->device upload and device digest of the next batch overlap this
    # batch's download + host formatting
    pending: deque = deque()
    statics = dict(
        kind=distance.kind,
        power=distance.power,
        normalize=normalize,
        k_cap=k_cap,
    )
    nq = queries.shape[0]
    batch_sizes = sorted({min(batch, nq - lo) for lo in range(0, nq, batch)})
    compiled = (
        _digest_compiled(td, md, tnd, batch_sizes, statics)
        if batch_sizes
        else {}
    )

    def _dispatch(lo: int):
        q = queries[lo : lo + batch]
        return lo, q, compiled[q.shape[0]](
            td, jnp.asarray(q, dtype=jnp.float32), md, tnd
        )

    use_native_fmt = _native_formatter()
    if use_native_fmt:
        from .. import native as _native

        col_blob, col_offs, col_lens = _native._names_blob(col_names)

    def _fallback_line(j_abs: int) -> str:
        row = _host_row(
            distance, metric, targets, tn, queries[j_abs], normalize
        )
        return (
            summarize_distance_row(req_len, m2.row_names[j_abs], row, col_names)
            + "\n"
        )

    def _drain_one():
        nonlocal n_rows, host_fallbacks
        lo, q, digs = pending.popleft()
        prog.update(lo)
        stats, top, idx = [np.asarray(x, dtype=np.float64) for x in digs]
        B = q.shape[0]
        # eff_len per row: whole tie groups until >= req_len (top is
        # ascending, so the selected entries are a prefix)
        kth_val = top[:, min(req_len, k_cap) - 1]
        eff = (top <= kth_val[:, None]).sum(axis=1)
        # tie groups that may extend beyond the device top-K: exact host row
        fallback = (eff >= k_cap) & (k_cap < N)
        # stable order by (distance, target index), vectorized rowwise:
        # stable-argsort by the secondary key, then by the gathered primary
        sec = np.argsort(idx, axis=1, kind="stable")
        order = np.take_along_axis(
            sec,
            np.argsort(
                np.take_along_axis(top, sec, 1), axis=1, kind="stable"
            ),
            1,
        )
        top_o = np.take_along_axis(top, order, 1)
        idx_o = np.take_along_axis(idx, order, 1)
        if use_native_fmt:
            eff_n = np.where(fallback, -1, eff).astype(np.int64)
            blob = _native.format_summary(
                m2.row_names[lo : lo + B], stats, top_o, idx_o, eff_n,
                col_blob, col_offs, col_lens,
            ).decode("utf-8")
            if fallback.any():
                # interleave exact host lines at their row positions.
                # Split on '\n' ONLY (the C formatter's one-\n-per-row
                # contract): str.splitlines also splits on \v, \f, \x85,
                # U+2028... inside names, which would misalign rows
                lines = [s + "\n" for s in blob.split("\n")[:-1]]
                merged, li = [], 0
                for j in range(B):
                    if fallback[j]:
                        merged.append(_fallback_line(lo + j))
                    else:
                        merged.append(lines[li])
                        li += 1
                blob = "".join(merged)
            out.write(blob)
            host_fallbacks += int(fallback.sum())
            n_rows += B - int(fallback.sum())
            return
        mean, std = stats[:, 0], stats[:, 1]
        for j in range(B):
            if fallback[j]:
                host_fallbacks += 1
                out.write(_fallback_line(lo + j))
                continue
            parts = [m2.row_names[lo + j]]
            parts += ["%.15g" % v for v in stats[j]]
            with np.errstate(divide="ignore", invalid="ignore"):
                for s in range(int(eff[j])):
                    d = top_o[j, s]
                    z = (d - mean[j]) / std[j]
                    parts += [
                        col_names[int(idx_o[j, s])], "%.15g" % d, "%.15g" % z
                    ]
            out.write("\t".join(parts) + "\n")
            n_rows += 1

    for lo in range(0, queries.shape[0], batch):
        pending.append(_dispatch(lo))
        if len(pending) >= 2:
            _drain_one()
    while pending:
        _drain_one()
    prog.done("queries.")
    return n_rows + host_fallbacks


def _host_row(distance, metric, targets, tnorms, query, normalize):
    q = query
    if normalize:
        nq = float(distance.compute_norm(metric, q))
        nq = 1.0 if nq == 0.0 else nq
        q = q / nq
    a = targets / tnorms[:, None]
    if distance.kind in ("euclidean", "cosine"):
        d2 = ((a - q[None, :]) ** 2 * metric[None, :]).sum(axis=1)
        return np.sqrt(d2) if distance.kind == "euclidean" else d2 / 2.0
    return (
        (np.abs(a - q[None, :]) ** distance.power * metric[None, :]).sum(axis=1)
    ) ** (1.0 / distance.power)


def distance_rowwise_device(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    normalize: bool = True,
    batch: int = 4096,
) -> NamedMatrix:
    """Full rectangular distance matrix on device (rows = m2's rows,
    cols = m1's rows, the ``get_distance_rowwise`` orientation,
    lib/Matrix.ml:191-266), blocked over query rows: the XLA matmul
    expansion in float32 on device (the float64 host path in core.space
    stays the golden reference).
    """
    targets = np.asarray(m1.data, dtype=np.float64)
    queries = np.asarray(m2.data, dtype=np.float64)
    if normalize:
        tn = distance.compute_norm(metric, targets)
        tn = np.where(tn == 0.0, 1.0, tn)
    else:
        tn = np.ones(targets.shape[0])
    td = jnp.asarray(targets, dtype=jnp.float32)
    md = jnp.asarray(metric, dtype=jnp.float32)
    tnd = jnp.asarray(tn, dtype=jnp.float32)
    out = np.zeros((queries.shape[0], targets.shape[0]))
    for lo in range(0, queries.shape[0], batch):
        q = queries[lo : lo + batch]
        block = _distance_rowwise_block(
            td,
            jnp.asarray(q, dtype=jnp.float32),
            md,
            tnd,
            kind=distance.kind,
            power=distance.power,
            normalize=normalize,
        )
        out[lo : lo + batch] = np.asarray(block, dtype=np.float64)
    return NamedMatrix(list(m2.row_names), list(m1.row_names), out)


@partial(jax.jit, static_argnames=("kind", "power", "normalize"))
def _distance_rowwise_block(
    targets, queries, metric, tnorms, kind, power, normalize
):
    a, b, m = targets, queries, metric
    if normalize:
        if kind == "euclidean":
            nb = jnp.sqrt((b * b * m[None, :]).sum(axis=1))
        elif kind == "cosine":
            nb = (b * b * m[None, :]).sum(axis=1) / 2.0
        else:
            nb = (jnp.abs(b) ** power * m[None, :]).sum(axis=1) ** (1.0 / power)
        nb = jnp.where(nb == 0.0, 1.0, nb)
        b = b / nb[:, None]
        a = a / tnorms[:, None]
    return _distance_block(a, b, m, kind, power)
