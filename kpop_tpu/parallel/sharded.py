"""Sharded multi-device compute paths: CA training, projection, distances.

These are the multi-device versions of the pipeline kernels, with explicit
``NamedSharding`` layouts over the (data, kmer) mesh; XLA inserts the
collectives:

- :func:`ca_fit_sharded`     — CA over a k-mer-sharded table: each shard's
  float64 Gram contribution is summed into a tiny [ns, ns] matrix that is
  eigendecomposed on the host; the twister stays k-mer-sharded.
- :func:`project_sharded`    — [B, K] x [K, d] contraction with B sharded
  over "data" and K over "kmer" (psum over "kmer").
- :func:`pairwise_sharded`   — query rows sharded over the whole mesh,
  targets replicated.

This replaces the reference's manual multi-node scatter + ``-a`` file merges
(README.md:1049-1067) with one SPMD program.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from .mesh import (  # noqa: E402
    DATA_AXIS,
    KMER_AXIS,
    device_canonical,
    pad_to_multiple,
)


class _PhaseTimer:
    """Per-phase wall timers for :func:`ca_fit_sharded`, printed to stderr
    when ``KPOP_CA_DEBUG`` is set (the analogue of the reference's hidden
    ``--debug-twisting`` timing, bin/KPopTwistDB.ml:350)."""

    def __init__(self, label: str):
        self.on = bool(os.environ.get("KPOP_CA_DEBUG"))
        self.label = label
        self.t = time.perf_counter()

    def mark(self, phase: str) -> None:
        if self.on:
            now = time.perf_counter()
            import sys

            sys.stderr.write(
                "%s[%s]: %.2f s\n" % (self.label, phase, now - self.t)
            )
            sys.stderr.flush()
            self.t = now


def _host(arr) -> np.ndarray:
    """Fetch a jax.Array to host, gathering across processes when its shards
    are not all addressable (multi-host runs)."""
    if arr.is_fully_replicated or arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


# ---------------- CA ----------------


def _ca_math(table, n_dims: int, d_full: int | None = None):
    """The CA factorization on a (possibly sharded) [K, ns] table.

    Pure jnp; sharding of ``table`` along axis 0 makes XLA compute the
    column sums and the Gram matrix with psums over the kmer axis.  This is
    the all-device "fast" path (dryruns, in-jit training steps); the
    float64 path lives in :func:`ca_fit_sharded`.
    """
    total = table.sum()
    P_ = table / total
    r = P_.sum(axis=1)  # [K] sharded
    c = P_.sum(axis=0)  # [ns] replicated (psum over kmer shards)
    r_safe = jnp.where(r > 0, r, 1.0)
    c_safe = jnp.where(c > 0, c, 1.0)
    S = (P_ - r[:, None] * c[None, :]) / jnp.sqrt(
        r_safe[:, None] * c_safe[None, :]
    )
    G = jnp.dot(
        S.T,
        S,
        preferred_element_type=S.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    evals, evecs = jnp.linalg.eigh(G)  # ascending
    # total inertia over the non-trivial spectrum (top min(nk,ns)-1: the
    # trailing eigenvalue is exactly zero in exact arithmetic), so n_dims
    # truncation reports each dim's share of the whole, matching R ca()'s
    # sv^2/sum(sv^2) over its nd = min(dim)-1 computed values
    nd = max(1, min(table.shape) - 1) if d_full is None else d_full
    total_in = jnp.maximum(evals[::-1][:nd], 0.0).sum()
    evals = evals[::-1][:n_dims]
    V = evecs[:, ::-1][:, :n_dims]
    evals = jnp.maximum(evals, 0.0)
    sv = jnp.sqrt(evals)
    # deterministic sign: largest-|.| component of each column positive
    amax = jnp.argmax(jnp.abs(V), axis=0)
    signs = jnp.sign(V[amax, jnp.arange(n_dims)])
    signs = jnp.where(signs == 0, 1.0, signs)
    V = V * signs[None, :]
    sample_coords = V * sv[None, :] / jnp.sqrt(c_safe)[:, None]
    sv_safe = jnp.where(sv > 0, sv, 1.0)
    phi = (
        jnp.dot(
            S,
            V / sv_safe[None, :],
            preferred_element_type=S.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        / jnp.sqrt(r_safe)[:, None]
    )
    phi = jnp.where((r > 0)[:, None], phi, 0.0)
    inertia = jnp.where(total_in > 0, evals / total_in, evals)
    return sample_coords, inertia, phi, sv  # phi [K, d] sharded over kmer


def _residual(x, alpha, u, beta, v):
    """Standardized CA residual ``S = x*alpha*beta - u v`` in float64 from a
    table block ``x`` (any wire dtype) and float64 row (``alpha``, ``u``)
    and column (``beta``, ``v``) vectors."""
    return (x.astype(jnp.float64) * alpha[:, None]) * beta[None, :] - (
        u[:, None] * v[None, :]
    )


def _gram_local(x, alpha, u, beta, v, acc, n_blocks: int = 16):
    """``acc + S^T S`` of one shard in float64.  The residual is rebuilt on
    the device block by block (a scan over ``n_blocks`` row blocks), so the
    float64 temporaries stay at 1/n_blocks of the shard.  Padded rows have
    ``alpha == u == 0`` and contribute nothing."""
    K, ns = x.shape
    blk = max(1, -(-K // n_blocks))
    pad = (-K) % blk
    x = jnp.pad(x, ((0, pad), (0, 0))).reshape(-1, blk, ns)
    alpha = jnp.pad(alpha, (0, pad)).reshape(-1, blk)
    u = jnp.pad(u, (0, pad)).reshape(-1, blk)

    def body(acc, inp):
        xq, aq, uq = inp
        s = _residual(xq, aq, uq, beta, v)
        return acc + jnp.dot(s.T, s, precision=jax.lax.Precision.HIGHEST), None

    acc, _ = jax.lax.scan(body, acc, (x, alpha, u))
    return acc


_CA_FN_CACHE: dict = {}


def _mesh_key(mesh: Mesh) -> tuple:
    """Stable cache key for a mesh: axis layout + the devices' own stable
    identifiers (``id()`` values can be reused after GC, which could alias a
    rebuilt mesh onto a stale jitted function)."""
    return (
        tuple(mesh.shape.items()),
        tuple(
            (d.id, getattr(d, "process_index", 0), d.platform)
            for d in mesh.devices.flat
        ),
    )


def _gram_fn_cached(mesh: Mesh):
    """Jitted per-shard float64 Gram with an explicit carry (one [ns, ns]
    partial per shard, summed on the host), cached per mesh: a fresh
    ``jax.jit(shard_map(...))`` every call would miss the jit cache and
    recompile on every CA fit."""
    key = ("gram", _mesh_key(mesh))
    if key not in _CA_FN_CACHE:
        rows = P((DATA_AXIS, KMER_AXIS))
        car = P((DATA_AXIS, KMER_AXIS), None, None)

        def local(x, alpha, u, beta, v, acc):
            return _gram_local(x, alpha, u, beta, v, acc[0])[None]

        _CA_FN_CACHE[key] = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P((DATA_AXIS, KMER_AXIS), None), rows, rows,
                          P(None), P(None), car),
                out_specs=car,
            )
        )
    return _CA_FN_CACHE[key]


def _phi_fn_cached(mesh: Mesh):
    """Jitted ``phi = D_r^-1/2 S V Sigma^-1`` of a row block in float64
    (residual rebuilt on the device), returned as float32 rows."""
    key = ("phi", _mesh_key(mesh))
    if key not in _CA_FN_CACHE:
        x_sharding = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))

        def fn(x, alpha, u, beta, v, vs, rs):
            s = _residual(x, alpha, u, beta, v)
            ph = jnp.dot(s, vs, precision=jax.lax.Precision.HIGHEST)
            return (ph * rs[:, None]).astype(jnp.float32)

        _CA_FN_CACHE[key] = jax.jit(fn, out_shardings=x_sharding)
    return _CA_FN_CACHE[key]


#: wire dtype of the last float64 ca_fit_sharded call: "u8"/"u16"/"f32"
#: when every table value is exactly representable in it, else "f64"
#: (introspection for tests and KPOP_CA_DEBUG).
LAST_CA_WIRE: str | None = None


def _compact_exact_cast(table: np.ndarray):
    """Return ``(compact_array, kind)`` when every table value is exactly
    representable in float32 — ``kind`` in {"u8", "u16", "f32"} picks the
    smallest wire dtype — else ``(None, None)``.  One blocked pass."""
    if table.dtype == np.float32:
        # signed tables take the f64 wire (keeps the integer kinds below
        # from ever seeing a negative value)
        if table.size and not (table >= 0).all():
            return None, None
        kind_arr = table
        is_int, mx, mn = False, None, None
        # still probe integrality/range for a smaller wire dtype
        is_int = bool((table == np.floor(table)).all())
        if is_int and table.size:
            mx = float(table.max())
    elif np.issubdtype(table.dtype, np.integer):
        mn = int(table.min()) if table.size else 0
        mx = int(table.max()) if table.size else 0
        if mn < 0 or mx >= (1 << 24):
            return None, None
        is_int, kind_arr = True, table
    elif table.dtype == np.float64:
        step = max(1, (8 << 20) // max(1, int(table.shape[1])))
        is_int, mx = True, 0.0
        for i in range(0, table.shape[0], step):
            blk = table[i : i + step]
            if not np.array_equal(blk, blk.astype(np.float32)):
                return None, None
            if blk.size and not (blk >= 0).all():  # see float32 case above
                return None, None
            if is_int and not (blk == np.floor(blk)).all():
                is_int = False
            m = float(blk.max()) if blk.size else 0.0
            mx = m if m > mx else mx
        kind_arr = table
    else:
        return None, None
    if is_int and mx is not None and mx < 256:
        return kind_arr.astype(np.uint8), "u8"
    if is_int and mx is not None and mx < 65536:
        return kind_arr.astype(np.uint16), "u16"
    return kind_arr.astype(np.float32), "f32"


#: stats of the last budgeted streamed CA fit (None when the resident
#: path ran): wire kind, block geometry, budget, per-device block bytes.
LAST_CA_STREAM: dict | None = None


def _hbm_budget(mesh: Mesh) -> int | None:
    """Per-device CA residency budget in bytes.

    ``KPOP_CA_HBM_BYTES`` overrides; otherwise 60% of the memory limit the
    device reports (:func:`kpop_tpu.device.memory_limit`; None, unbudgeted,
    on CPU meshes).  The reference's CA is bounded only by host RAM
    (src/KPopTwist:95-96, R ``ca()``); this is the device-side equivalent
    of that bound, turning would-be OOMs at the k=12 flagship table
    (~16.7M k-mers x 1000 samples, README.md:530) into streamed fits.
    """
    from ..device import memory_budget

    return memory_budget(mesh.devices.flat[0], "KPOP_CA_HBM_BYTES", 0.6)


def _stream_block_rows(
    budget_dev: int, ns: int, d: int, wire_bytes: int, n_shards: int
) -> int:
    """Rows per streamed block such that per-device residency stays within
    ``budget_dev``: two blocks in flight (upload of b+1 overlaps compute of
    b) plus fixed carries/vectors plus temporary headroom."""
    # fixed per device: up to 3 live [ns, ns] f64 carries, the replicated
    # [ns, d] f64 V/sigma factor, the column vectors
    fixed = 3 * ns * ns * 8 + ns * d * 8 + 4 * ns * 8
    # per row, spread over all shards: the wire block, the [*, d] f32 phi
    # output, 2 f64 row-vector entries, and the f64 residual of the phi
    # pass (the Gram pass holds 1/16 of it at a time)
    per_row = (ns * wire_bytes + 4 * d + 16 + 8 * ns) / n_shards
    avail = max(0.0, (budget_dev - fixed) * 0.45)
    rows_dev = int(avail / per_row)
    if rows_dev < 1:
        import sys

        sys.stderr.write(
            "ca_fit_sharded: KPOP_CA_HBM_BYTES=%d is below the minimum "
            "streamable block (~%d B/device); clamping to %d rows/block\n"
            % (budget_dev, int(fixed + per_row * n_shards), n_shards)
        )
        rows_dev = 1
    return rows_dev * n_shards


def _ca_fit_streamed(
    mesh: Mesh,
    wire: np.ndarray,
    kind: str,
    d: int,
    vectors: tuple,
    phi: str,
    budget_dev: int,
    tm: "_PhaseTimer",
    verbose: bool = False,
    on_block=None,
):
    """Budgeted CA fit: upload -> accumulate -> DISCARD row blocks for the
    Gram pass, then a second streamed pass re-uploading each block for
    phi.  Device residency stays within ``budget_dev`` per device instead
    of pinning the whole padded table (the resident path), so tables
    bigger than the mesh's combined memory train instead of OOMing.

    The budget bounds the *wire and intermediate* residency.  With
    ``phi="device"`` the full ``[K, d]`` float32 twister additionally
    accumulates on the mesh — it IS the requested output; when its
    estimated footprint exceeds the budget a warning points at
    ``phi="host"`` (host-resident twister) or the kmer-sharded serving
    layout (``parallel/serving.py``).

    ``on_block`` (test hook): called after each block's backpressure step —
    the bounded-residency test probes ``jax.live_arrays()`` there.
    """
    from collections import deque

    from ..utils.progress import Progress

    alpha, u, beta, v, rs_full, c_safe = vectors
    nk, ns = wire.shape
    n_shards = mesh.devices.size
    x_sharding = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))
    row_sh = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS)))
    rep_sh = NamedSharding(mesh, P(None))
    wire_bytes = wire.dtype.itemsize
    blkK = _stream_block_rows(budget_dev, ns, d, wire_bytes, n_shards)
    n_blocks = -(-nk // blkK)
    global LAST_CA_STREAM
    LAST_CA_STREAM = {
        "wire": kind,
        "block_rows": blkK,
        "n_blocks": n_blocks,
        "budget_bytes_per_device": budget_dev,
        "block_bytes_per_device": blkK * ns * wire_bytes // n_shards,
        "max_live_blocks": 2,
    }
    bd = jax.device_put(beta, rep_sh)
    vd = jax.device_put(v, rep_sh)

    def _block_arrays(b: int):
        """Upload block b (wire rows + row vectors), zero-padded to blkK
        rows; returns the device arrays."""
        i0, i1 = b * blkK, min(nk, (b + 1) * blkK)
        pad = blkK - (i1 - i0)
        xb = wire[i0:i1]
        if pad:
            xb = np.concatenate([xb, np.zeros((pad, ns), xb.dtype)], axis=0)
        return [
            jax.device_put(xb, x_sharding),
            jax.device_put(np.pad(alpha[i0:i1], (0, pad)), row_sh),
            jax.device_put(np.pad(u[i0:i1], (0, pad)), row_sh),
        ]

    def _drain(pending: deque, keep: int) -> None:
        """Backpressure: once more than ``keep`` blocks are in flight,
        wait for the oldest block's result and DELETE its uploads."""
        while len(pending) > keep:
            refs, result = pending.popleft()
            jax.block_until_ready(result)
            for a in refs:
                a.delete()
            if on_block is not None:
                on_block()

    # ---- pass 1: streamed Gram ----
    gram_fn, phi_fn = _gram_fn_cached(mesh), _phi_fn_cached(mesh)
    car_sh = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None, None))
    acc = jax.device_put(np.zeros((n_shards, ns, ns)), car_sh)
    pending: deque = deque()
    prog = Progress(
        "ca_fit_sharded", "Streaming Gram blocks", n_blocks,
        enabled=True if verbose else None,
    )
    for b in range(n_blocks):
        # retire block b-2 BEFORE uploading block b: at most two blocks
        # (b-1 computing, b uploading) are ever device-resident, which is
        # what _stream_block_rows sizes the budget for
        _drain(pending, keep=1)
        refs = _block_arrays(b)
        acc = gram_fn(*refs, bd, vd, acc)
        pending.append((refs, acc))
        prog.update(b + 1)
    _drain(pending, keep=0)
    prog.done()
    G = np.asarray(_host(acc)).sum(axis=0)
    tm.mark("gram-streamed[%d blocks]" % n_blocks)
    sample_coords, inertia, sv, V, sv_safe = _factor_gram_host(
        G, d, c_safe, max(1, min(nk, ns) - 1)
    )
    tm.mark("eigh")
    # ---- pass 2: streamed phi (re-upload each block, then discard) ----
    Vs_d = jax.device_put(
        V / sv_safe[None, :], NamedSharding(mesh, P(None, None))
    )
    if phi == "device":
        out_dev_bytes = n_blocks * blkK * d * 4 // n_shards
        if out_dev_bytes > budget_dev:
            import sys

            sys.stderr.write(
                "ca_fit_sharded: phi='device' keeps the full [%d, %d] f32 "
                "twister device-resident (~%d B/device, above the %d B "
                "budget); use phi='host' or serve through the kmer-sharded "
                "layout (parallel/serving.py)\n"
                % (nk, d, out_dev_bytes, budget_dev)
            )
    host_blocks: list = []
    dev_blocks: list = []
    pending = deque()
    prog = Progress(
        "ca_fit_sharded", "Streaming phi blocks", n_blocks,
        enabled=True if verbose else None,
    )

    def _retire_to_host() -> None:
        oldrefs, oldph = pending.popleft()
        host_blocks.append(np.asarray(_host(oldph), dtype=np.float64))
        for a in oldrefs:
            a.delete()
        oldph.delete()
        if on_block is not None:
            on_block()

    for b in range(n_blocks):
        # as in the Gram pass: retire block b-2 before uploading block b so
        # at most two wire blocks are in flight
        if phi == "device":
            _drain(pending, keep=1)
        elif len(pending) > 1:
            _retire_to_host()  # the host fetch blocks: natural backpressure
        refs = _block_arrays(b)
        rs_blk = np.zeros(blkK)
        seg = rs_full[b * blkK : min(nk, (b + 1) * blkK)]
        rs_blk[: seg.shape[0]] = seg
        rs_d = jax.device_put(rs_blk, row_sh)
        ph = phi_fn(*refs, bd, vd, Vs_d, rs_d)
        if phi == "device":
            dev_blocks.append(ph)
        pending.append((refs + [rs_d], ph))
        prog.update(b + 1)
    if phi == "device":
        _drain(pending, keep=0)
        tw = _concat_fn_cached(mesh, len(dev_blocks))(*dev_blocks)[:nk]
    else:
        while pending:
            _retire_to_host()
        tw = np.concatenate(host_blocks)[:nk].T
    prog.done()
    tm.mark("phi-streamed[%d blocks]" % n_blocks)
    return (sample_coords, inertia, tw, sv)


def _concat_fn_cached(mesh: Mesh, n_blocks: int):
    """Jitted row-wise concat of the per-block phi results, cached per
    (mesh, block count) so the device twister stays sharded end to end."""
    key = ("concat", n_blocks, _mesh_key(mesh))
    if key not in _CA_FN_CACHE:
        if n_blocks == 1:
            _CA_FN_CACHE[key] = lambda x: x
        else:
            x_sharding = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))
            _CA_FN_CACHE[key] = jax.jit(
                lambda *xs: jnp.concatenate(xs, axis=0),
                out_shardings=x_sharding,
            )
    return _CA_FN_CACHE[key]


def _factor_gram_host(G: np.ndarray, d: int, c_safe: np.ndarray,
                      d_full: int):
    """Host float64 eigendecomposition of the [ns, ns] Gram + the CA output
    conventions (descending order, deterministic column signs, principal
    sample coordinates) — shared by the resident and streamed paths.

    ``d_full`` = min(nk, ns) - 1, the non-trivial spectrum size: inertia is
    normalized over the top ``d_full`` eigenvalues BEFORE truncating to
    ``d``, so n_dims-truncated fits report each dim's share of the whole
    (R ca()'s sv^2/sum(sv^2)), not of the kept dims — and the trailing
    eigenvalue (exactly zero in exact arithmetic) stays out of the total.
    """
    evals, evecs = np.linalg.eigh(G)
    order = np.argsort(evals)[::-1]
    ev_desc = evals[order]
    total_in = float(np.maximum(ev_desc[: max(1, d_full)], 0.0).sum())
    evals, evecs = ev_desc[:d], evecs[:, order][:, :d]
    evals = np.maximum(evals, 0.0)
    sv = np.sqrt(evals)
    signs = np.sign(evecs[np.argmax(np.abs(evecs), axis=0), np.arange(d)])
    signs = np.where(signs == 0, 1.0, signs)
    V = evecs * signs[None, :]
    sample_coords = V * sv[None, :] / np.sqrt(c_safe)[:, None]
    sv_safe = np.where(sv > 0, sv, 1.0)
    inertia = evals / total_in if total_in > 0 else evals
    return sample_coords, inertia, sv, V, sv_safe


def ca_fit_sharded(
    mesh: Mesh,
    table: np.ndarray,
    n_dims: int | None = None,
    precision: str = "f64",
    phi: str = "host",
    col_weights: np.ndarray | None = None,
    hbm_bytes: int | None = None,
    verbose: bool = False,
    _stream_probe=None,
):
    """Fit CA with the k-mer axis sharded across the whole mesh.

    ``table``: host [n_kmers, n_samples].  Returns
    (sample_coords, inertia, twister, sv) — host float64 arrays, except that
    with ``phi="device"`` the twister comes back as the device-resident
    ``[K, d]`` float32 row matrix (k-mers x dims, table row order, sharded
    over the mesh) instead of the host ``[d, K]`` transpose.  The device
    form feeds straight into serving (``ClassifierParams.twister``) without
    a download+re-upload round trip.

    ``precision="f64"`` (default): the table is uploaded once in the
    smallest dtype that holds it exactly (uint8/uint16/float32 for counts,
    else float64; :data:`LAST_CA_WIRE`), and the standardized residual, its
    Gram matrix and phi are computed on the device in float64 (64-bit mode
    is enabled for the CA's own computations only).  Each shard's [ns, ns]
    Gram is summed and eigendecomposed on the host in float64.  A float32
    Gram loses the small eigenvalues of tables whose columns are nearly
    collinear, such as closely related classes.
    ``precision="fast"``: everything on device in float32 (:func:`_ca_math`).

    ``col_weights``: optional per-column multipliers applied to the table
    (the KPopTwist driver's per-spectrum normalization, src/KPopTwist:92-94)
    — passing them separately keeps an integer table on a compact wire
    instead of forcing a float64 materialization.

    ``hbm_bytes``: per-device residency budget (default: the
    ``KPOP_CA_HBM_BYTES`` env var, else 60% of the device memory limit;
    unbudgeted on CPU).  When the resident path would exceed it, the fit
    switches to :func:`_ca_fit_streamed`: Gram blocks are uploaded,
    accumulated, and DISCARDED, then a second streamed pass re-uploads each
    block for phi — bounded device memory at any table size
    (:data:`LAST_CA_STREAM` records the block geometry).
    ``verbose`` adds live block progress on stderr; ``_stream_probe`` is a
    test hook called once per retired block.
    """
    nk, ns = table.shape
    # cap at the non-trivial spectrum (see core/ca.py::fit_ca): an
    # over-large n_dims would keep a pure-noise phi column
    d_full = max(1, min(nk, ns) - 1)
    d = d_full if n_dims is None else max(1, min(n_dims, d_full))
    n_shards = mesh.devices.size
    x_sharding = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))
    if precision == "fast":
        if col_weights is not None:
            table = np.asarray(table) * np.asarray(col_weights)[None, :]
        padded, orig = pad_to_multiple(device_canonical(table), 0, n_shards)
        xs = jax.device_put(padded, x_sharding)
        key = ("fast", d, d_full, _mesh_key(mesh))
        if key not in _CA_FN_CACHE:
            _CA_FN_CACHE[key] = jax.jit(
                lambda t: _ca_math(t, d, d_full),
                out_shardings=(
                    NamedSharding(mesh, P(None, None)),
                    NamedSharding(mesh, P(None)),
                    x_sharding,
                    NamedSharding(mesh, P(None)),
                ),
            )
        coords, inertia, phi_d, sv = _CA_FN_CACHE[key](xs)
        tw = phi_d[:orig] if phi == "device" else _host(phi_d)[:orig].T
        return (_host(coords), _host(inertia), tw, _host(sv))
    if precision != "f64":
        raise ValueError(f"unknown CA precision {precision!r}")
    global LAST_CA_WIRE, LAST_CA_STREAM
    tm = _PhaseTimer("ca_fit_sharded")
    N = np.asarray(table)
    w = (
        None
        if col_weights is None
        else np.asarray(col_weights, dtype=np.float64)
    )
    # ---- masses in host float64 (one pass; weights folded, not applied) --
    if w is None:
        roww = N.sum(axis=1, dtype=np.float64)
        colw = N.sum(axis=0, dtype=np.float64)
    else:
        # blocked N @ w: a whole-table astype(float64) would double the
        # table's memory (8 B/entry) exactly at the flagship shapes the
        # streaming path exists for
        roww = np.empty(N.shape[0], dtype=np.float64)
        step = max(1, (64 << 20) // max(1, N.shape[1] * 8))
        for i in range(0, N.shape[0], step):
            roww[i : i + step] = N[i : i + step].astype(np.float64) @ w
        colw = N.sum(axis=0, dtype=np.float64) * w
    total = float(roww.sum())
    r = roww / total
    c = colw / total
    r_safe = np.where(r > 0, r, 1.0)
    c_safe = np.where(c > 0, c, 1.0)
    alpha = 1.0 / np.sqrt(r_safe)
    inv_sc = 1.0 / np.sqrt(c_safe)
    u = r * alpha  # sqrt(r), 0 where r == 0
    v = c * inv_sc
    beta = (w if w is not None else 1.0) * inv_sc / total
    rs = alpha * (r > 0)  # phi = D_r^-1/2 S V / sv, zero rows where r == 0
    tm.mark("masses")
    compact, kind = _compact_exact_cast(N)
    if compact is None:
        compact, kind = N.astype(np.float64), "f64"
    LAST_CA_WIRE = kind
    LAST_CA_STREAM = None
    budget = hbm_bytes if hbm_bytes is not None else _hbm_budget(mesh)
    with jax.enable_x64(True):
        if budget:
            pad_rows = -(-nk // n_shards) * n_shards
            resident_dev = (
                pad_rows * (ns * (compact.itemsize + 8) + d * 4) / n_shards
            )
            if resident_dev > budget:
                return _ca_fit_streamed(
                    mesh, compact, kind, d,
                    (alpha, u, beta, v, rs, c_safe), phi, budget, tm,
                    verbose=verbose, on_block=_stream_probe,
                )
        Xp, _ = pad_to_multiple(compact, 0, n_shards)
        pad = Xp.shape[0] - nk
        row_sh = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS)))
        rep_sh = NamedSharding(mesh, P(None))
        car_sh = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None, None))
        # padded rows: alpha == u == 0 -> zero residual
        args = (
            jax.device_put(Xp, x_sharding),
            jax.device_put(np.pad(alpha, (0, pad)), row_sh),
            jax.device_put(np.pad(u, (0, pad)), row_sh),
            jax.device_put(beta, rep_sh),
            jax.device_put(v, rep_sh),
        )
        tm.mark("upload")
        acc = _gram_fn_cached(mesh)(
            *args, jax.device_put(np.zeros((n_shards, ns, ns)), car_sh)
        )
        G = np.asarray(_host(acc)).sum(axis=0)
        tm.mark("gram")
        sample_coords, inertia, sv, V, sv_safe = _factor_gram_host(
            G, d, c_safe, d_full
        )
        tm.mark("eigh")
        phi_d = _phi_fn_cached(mesh)(
            *args,
            jax.device_put(V / sv_safe[None, :], NamedSharding(mesh, P(None, None))),
            jax.device_put(np.pad(rs, (0, pad)), row_sh),
        )
    tw = (
        phi_d[:nk]
        if phi == "device"
        else np.asarray(_host(phi_d), dtype=np.float64)[:nk].T
    )
    tm.mark("phi")
    return (sample_coords, inertia, tw, sv)


# ---------------- projection ----------------


def project_sharded(
    mesh: Mesh,
    spectra: np.ndarray,
    twister_t: np.ndarray,
    normalize: bool = True,
):
    """[B, K] spectra x [K, d] twister^T with B over "data", K over "kmer"."""
    n_data = mesh.shape[DATA_AXIS]
    n_kmer = mesh.shape[KMER_AXIS]
    xs, B = pad_to_multiple(device_canonical(spectra), 0, n_data)
    xs, K = pad_to_multiple(xs, 1, n_kmer)
    tw, _ = pad_to_multiple(device_canonical(twister_t), 0, n_kmer)
    x_sh = NamedSharding(mesh, P(DATA_AXIS, KMER_AXIS))
    w_sh = NamedSharding(mesh, P(KMER_AXIS, None))
    xs = jax.device_put(xs, x_sh)
    tw = jax.device_put(tw, w_sh)

    def fn(x, w):
        if normalize:
            sums = x.sum(axis=1, keepdims=True)  # psum over kmer shards
            x = x / jnp.where(sums == 0.0, 1.0, sums)
        return jnp.dot(
            x, w, preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )

    out = jax.jit(
        fn, out_shardings=NamedSharding(mesh, P(DATA_AXIS, None))
    )(xs, tw)
    return _host(out)[:B]


# ---------------- pairwise distances ----------------


def pairwise_sharded(
    mesh: Mesh,
    queries: np.ndarray,
    targets: np.ndarray,
    metric: np.ndarray,
    normalize: bool = True,
):
    """Metric-weighted euclidean distances [B, T]: queries sharded over the
    whole mesh (both axes), targets replicated — the layout for the
    classification workload where T (classes) << B (sequences)."""
    n_shards = mesh.devices.size
    q, B = pad_to_multiple(device_canonical(queries), 0, n_shards)
    q_sh = NamedSharding(mesh, P((DATA_AXIS, KMER_AXIS), None))
    rep = NamedSharding(mesh, P(None, None))
    qd = jax.device_put(q, q_sh)
    td = jax.device_put(device_canonical(targets), rep)
    md = jax.device_put(device_canonical(metric), NamedSharding(mesh, P(None)))

    def fn(a, b, m):
        if normalize:
            na = jnp.sqrt((a * a * m[None, :]).sum(axis=1))
            na = jnp.where(na == 0.0, 1.0, na)
            a = a / na[:, None]
            nb = jnp.sqrt((b * b * m[None, :]).sum(axis=1))
            nb = jnp.where(nb == 0.0, 1.0, nb)
            b = b / nb[:, None]
        am = a * m[None, :]
        cross = jnp.dot(
            am, b.T, preferred_element_type=a.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        na2 = (am * a).sum(axis=1)
        nb2 = (b * b * m[None, :]).sum(axis=1)
        d2 = jnp.maximum(na2[:, None] + nb2[None, :] - 2.0 * cross, 0.0)
        return jnp.sqrt(d2)

    out = jax.jit(fn, out_shardings=q_sh)(qd, td, md)
    return _host(out)[:B]
