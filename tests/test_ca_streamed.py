"""Budgeted streaming CA: parity with the resident paths and bounded
per-device residency under an artificially tiny budget.

The reference's CA is bounded only by host RAM (src/KPopTwist:95-96); the
device equivalent must turn "table > device memory" into a streamed fit, not an OOM.
"""

import numpy as np
import pytest

from kpop_tpu.core.ca import fit_ca


@pytest.fixture(scope="module")
def mesh():
    from kpop_tpu.parallel.mesh import make_mesh

    m = make_mesh(8)
    assert m.devices.size == 8
    return m


def _assert_ca_equal(got, want, rtol=1e-5, atol=1e-7):
    """Eigenvalues (inertia, sv) are stable under the ~1e-7-relative Gram
    perturbations of different block groupings (Weyl), so they compare
    tightly; eigenvector-derived outputs (coords, twister) inherit a
    1/eigengap amplification on random tables with clustered spectra, so
    they get a looser bound."""
    coords, inertia, twister, sv = got
    np.testing.assert_allclose(inertia, want.inertia, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sv, want.sv, rtol=rtol, atol=atol)
    for j in range(want.n_dims):
        a, b = coords[:, j], want.sample_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(
            twister[j], sign * want.twister[j], rtol=1e-3, atol=1e-5
        )


@pytest.mark.parametrize("wire", ["u8", "u16", "f64"])
def test_streamed_matches_host(mesh, wire):
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(3)
    if wire == "u8":
        table = rng.integers(0, 200, size=(4096, 9)).astype(np.int32)
    elif wire == "u16":
        table = rng.integers(0, 60000, size=(4096, 9)).astype(np.int32)
    else:
        # f32-inexact values force the f64 wire
        table = rng.random((4096, 9)) + 0.1
    budget = 4 << 10  # 4 KiB/device: far below the resident footprint
    got = sharded.ca_fit_sharded(mesh, table, hbm_bytes=budget)
    assert sharded.LAST_CA_STREAM is not None, "streamed path did not run"
    assert sharded.LAST_CA_STREAM["wire"] == wire
    assert sharded.LAST_CA_STREAM["n_blocks"] > 1
    want = fit_ca(table.astype(np.float64))
    _assert_ca_equal(got, want, rtol=1e-5, atol=1e-7)
    # and the streamed result must match the resident path bit-for-bit
    # in structure (same wire, same math) to tight tolerance
    res = sharded.ca_fit_sharded(mesh, table, hbm_bytes=None)
    assert sharded.LAST_CA_STREAM is None
    np.testing.assert_allclose(got[2], res[2], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got[0], res[0], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got[1], res[1], rtol=1e-6, atol=1e-9)


def test_streamed_with_col_weights(mesh):
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(4)
    table = rng.integers(0, 50, size=(2048, 6)).astype(np.int32)
    w = 1.0 / np.maximum(table.sum(axis=0), 1.0)
    got = sharded.ca_fit_sharded(
        mesh, table, col_weights=w, hbm_bytes=4 << 10
    )
    assert sharded.LAST_CA_STREAM is not None
    want = fit_ca(table.astype(np.float64) * w[None, :])
    _assert_ca_equal(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("wire", ["u8", "f64"])
def test_streamed_phi_device(mesh, wire):
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(5)
    if wire == "u8":
        table = rng.integers(0, 100, size=(2048, 5)).astype(np.int32)
    else:
        table = rng.random((2048, 5)) + 0.05
    c, i, tw_dev, s = sharded.ca_fit_sharded(
        mesh, table, hbm_bytes=4 << 10, phi="device"
    )
    assert sharded.LAST_CA_STREAM is not None
    assert sharded.LAST_CA_STREAM["wire"] == wire
    c2, i2, tw_host, s2 = sharded.ca_fit_sharded(mesh, table)
    # device twister is the [K, d] row layout of the host [d, K] transpose
    np.testing.assert_allclose(
        np.asarray(tw_dev), tw_host.T, rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(c, c2, rtol=1e-3, atol=1e-7)


def test_streamed_residency_is_bounded(mesh):
    """With a tiny budget, the total bytes of live staged jax.Arrays must
    stay within a small multiple of the budget at every block-retire point
    — the table must never be device-resident all at once."""
    import jax

    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(6)
    ns = 8
    table = rng.integers(0, 200, size=(4096, ns)).astype(np.int32)
    budget = 4 << 10  # 4 KiB/device
    max_live = {"bytes": 0}

    def probe():
        live = sum(
            a.nbytes for a in jax.live_arrays() if a.nbytes > 4096
        )
        max_live["bytes"] = max(max_live["bytes"], live)

    got = sharded.ca_fit_sharded(
        mesh, table, hbm_bytes=budget, _stream_probe=probe
    )
    stats = sharded.LAST_CA_STREAM
    assert stats is not None and stats["n_blocks"] >= 4
    assert max_live["bytes"] > 0, "probe never ran"
    # resident footprint would be ~table + phi: prove we stayed far below
    resident = table.size * 1 + table.shape[0] * (ns - 1) * 4
    assert max_live["bytes"] < resident, (
        f"live {max_live['bytes']} >= resident {resident}"
    )
    # and within the declared block accounting: 2 blocks in flight + carries
    # + the device-side [ns, ns] factors (all 8 shards visible on one host)
    n_sh = mesh.devices.size
    cap = (
        2 * stats["block_bytes_per_device"] * n_sh * 6  # blocks + temps
        + budget * n_sh  # fixed carries/vectors headroom
    )
    assert max_live["bytes"] <= cap, (
        f"live {max_live['bytes']} > cap {cap}"
    )
    _assert_ca_equal(got, fit_ca(table.astype(np.float64)), 1e-5, 1e-7)


def test_unbudgeted_default_unchanged(mesh):
    """Without a budget (CPU default), the resident path runs as before."""
    from kpop_tpu.parallel import sharded

    table = np.arange(120, dtype=np.int32).reshape(30, 4) % 17
    sharded.ca_fit_sharded(mesh, table)
    assert sharded.LAST_CA_STREAM is None
    assert sharded.LAST_CA_WIRE == "u8"


def test_streamed_truncated_dims(mesh):
    """n_dims truncation through the streamed path (the single-chip
    flagship mode: full k=12 vocab, leading dims only — the full-dim
    twister would not fit one device) matches the full fit's leading
    dims."""
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(7)
    table = rng.integers(0, 150, size=(3072, 9)).astype(np.int32)
    c, i, tw, s = sharded.ca_fit_sharded(
        mesh, table, n_dims=3, hbm_bytes=4 << 10, phi="device"
    )
    assert sharded.LAST_CA_STREAM is not None
    assert np.asarray(tw).shape == (3072, 3)
    full = fit_ca(table.astype(np.float64))
    assert i.shape == (3,) and s.shape == (3,)
    np.testing.assert_allclose(i, full.inertia[:3], rtol=1e-5, atol=1e-7)
    for j in range(3):
        a, b = c[:, j], full.sample_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(tw)[:, j], sign * full.twister[j], rtol=1e-3,
            atol=1e-5,
        )


def test_streamed_device_twister_serves(mesh):
    """The flagship single-chip mode end to end at CI scale: stream-fit a
    FULL-vocabulary table with truncated dims and phi='device', wire the
    device-resident twister straight into ClassifierParams (identity LUT:
    row i = k-mer code i, as in benchmarks/flagship_ca.py), and classify —
    predictions must match the host float64 golden chain."""
    import jax.numpy as jnp

    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.core.space import Distance, normalizations
    from kpop_tpu.ops.pipeline import (
        ClassifierParams,
        count_spectra,
        distances_to_classes,
        project,
        summarize_batch,
    )
    from kpop_tpu.parallel import sharded

    k, D = 6, 3
    space = KmerSpace("DNA-ds", k)
    NK = space.n_kmers  # full 4^6 code space
    rng = np.random.default_rng(11)
    blk = rng.integers(0, 256, size=(NK, 8), dtype=np.uint8)
    table = np.where(blk < 64, blk, 0).astype(np.uint8)
    coords, inertia, tw_dev, sv = sharded.ca_fit_sharded(
        mesh, table, n_dims=D, hbm_bytes=4 << 10, phi="device"
    )
    assert sharded.LAST_CA_STREAM is not None
    assert tuple(tw_dev.shape) == (NK, D)
    lut = np.arange(NK + 1, dtype=np.int32)  # trash -> row NK
    metric = np.full(D, 1.0 / D)
    cls_norms = normalizations(
        Distance.of_string("euclidean"), metric, coords
    )
    params = ClassifierParams(
        vocab_lut=jnp.asarray(lut),
        twister=tw_dev,
        metric=jnp.asarray(metric, jnp.float32),
        class_coords=jnp.asarray(coords.astype(np.float32)),
        class_norms=jnp.asarray(cls_norms.astype(np.float32)),
        k=k,
        canonical=True,
    )
    B, L = 4, 600
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    spectra = count_spectra(params, jnp.asarray(codes))
    twisted = project(params, spectra)
    dmat = distances_to_classes(params, twisted)
    _m, _s, _md, _mad, _top, idx = summarize_batch(dmat, 2)
    got = np.asarray(idx)[:, 0]

    # host float64 golden chain on the same queries
    from kpop_tpu.core.count import spectrum_of_sequences

    full = fit_ca(table.astype(np.float64), n_dims=D)
    bases = np.array(list("ACGT"))
    want = []
    for b in range(B):
        seq = "".join(bases[codes[b]])
        cs, vs = spectrum_of_sequences(space, [seq])
        spec = np.zeros(NK)
        spec[np.asarray(cs, dtype=np.int64)] = vs
        spec /= spec.sum()
        tw = spec @ full.twister.T  # [D]
        d2 = (
            ((full.sample_coords - tw[None, :]) ** 2) * metric[None, :]
        ).sum(axis=1)
        dists = np.sqrt(d2)
        nq = np.sqrt((tw * tw * metric).sum())
        nc = cls_norms
        d2n = (
            ((full.sample_coords / nc[:, None] - (tw / nq)[None, :]) ** 2)
            * metric[None, :]
        ).sum(axis=1)
        want.append(int(np.argmin(np.sqrt(d2n))))
    assert list(got) == want, (list(got), want)
