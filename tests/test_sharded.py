"""Multi-chip sharded paths on a virtual 8-device CPU mesh must agree with
the single-device numpy golden paths (SURVEY.md §4)."""

import numpy as np
import pytest

from kpop_tpu.core.ca import fit_ca


@pytest.fixture(scope="module")
def mesh():
    from kpop_tpu.parallel.mesh import make_mesh

    m = make_mesh(8)
    assert m.devices.size == 8
    return m


def test_mesh_axes(mesh):
    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS

    assert set(mesh.axis_names) == {DATA_AXIS, KMER_AXIS}


def test_ca_fit_sharded_matches_host(mesh):
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    rng = np.random.default_rng(0)
    table = rng.integers(0, 30, size=(101, 7)).astype(np.float64) + 0.05
    coords, inertia, twister, sv = ca_fit_sharded(mesh, table)
    want = fit_ca(table)
    np.testing.assert_allclose(inertia, want.inertia, rtol=1e-3, atol=1e-6)
    for j in range(want.n_dims):
        a, b = coords[:, j], want.sample_coords[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=1e-2, atol=1e-4)
        np.testing.assert_allclose(
            twister[j], sign * want.twister[j], rtol=1e-2, atol=1e-4
        )


def test_project_sharded_matches_host(mesh):
    from kpop_tpu.parallel.sharded import project_sharded

    rng = np.random.default_rng(1)
    spectra = rng.random((13, 50)).astype(np.float32)
    tw = rng.standard_normal((50, 6)).astype(np.float32)
    got = project_sharded(mesh, spectra, tw)
    want = (spectra / spectra.sum(axis=1, keepdims=True)) @ tw
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_pairwise_sharded_matches_host(mesh):
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import Distance, distance_rowwise
    from kpop_tpu.parallel.sharded import pairwise_sharded

    rng = np.random.default_rng(2)
    d = 9
    queries = rng.standard_normal((21, d))
    targets = rng.standard_normal((5, d))
    metric = rng.random(d)
    metric /= metric.sum()
    got = pairwise_sharded(mesh, queries, targets, metric)
    m1 = NamedMatrix([f"t{i}" for i in range(5)], [f"d{j}" for j in range(d)], targets)
    m2 = NamedMatrix([f"q{i}" for i in range(21)], [f"d{j}" for j in range(d)], queries)
    want = distance_rowwise(Distance.of_string("euclidean"), metric, m1, m2).data
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_ca_dd_precision_tight(mesh):
    """The default float64 path (device f64 Gram + host f64 eigh) must match the
    host float64 CA to tight tolerances — no per-dimension sign fixups
    needed since both use the same deterministic sign convention."""
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    rng = np.random.default_rng(3)
    table = rng.random((513, 9)) * 10.0
    coords, inertia, twister, sv = ca_fit_sharded(mesh, table)
    want = fit_ca(table)
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-8)
    np.testing.assert_allclose(inertia, want.inertia, rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        coords, want.sample_coords, rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=1e-5)


def test_ca_dd_beats_fast_at_long_axis(mesh):
    """At a 200K-row k-mer axis the float64 Gram must actually change the
    answer: both sample coordinates and singular values come out an order
    of magnitude closer to the float64 host CA than the all-f32 device path
    (asserted >=5x with absolute caps)."""
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    rng = np.random.default_rng(4)
    table = rng.random((200_000, 7)) * 10.0
    want = fit_ca(table)
    c_dd, _i, t_dd, sv_dd = ca_fit_sharded(mesh, table, precision="f64")
    c_f, _i, t_f, sv_f = ca_fit_sharded(mesh, table, precision="fast")
    err = lambda a, b: np.abs(a - b).max()  # noqa: E731
    assert err(sv_dd, want.sv) < 1e-8
    assert err(c_dd, want.sample_coords) < 5e-6
    assert err(c_dd, want.sample_coords) * 5 < err(c_f, want.sample_coords)
    assert err(sv_dd, want.sv) * 5 < err(sv_f, want.sv)
    assert err(t_dd, want.twister) * 5 < err(t_f, want.twister)


def test_ca_dd_multi_block(mesh):
    """A tiny budget forces the float64 path through several streamed
    upload blocks; parity with host f64 and with phi='device' must hold
    across the block boundaries (incl. the zero-padded tail of the last
    block)."""
    import jax.numpy as jnp

    from kpop_tpu.parallel import sharded
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    rng = np.random.default_rng(11)
    table = rng.random((531, 6)) * 10.0  # 531 rows: ragged last block
    want = fit_ca(table)
    coords, inertia, twister, sv = ca_fit_sharded(
        mesh, table, hbm_bytes=2 << 10  # several blocks, ragged tail
    )
    assert sharded.LAST_CA_STREAM["n_blocks"] > 2
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-8)
    np.testing.assert_allclose(coords, want.sample_coords, rtol=0, atol=1e-6)
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=1e-5)
    _c, _i, tw_dev, _s = ca_fit_sharded(
        mesh, table, phi="device", hbm_bytes=2 << 10
    )
    assert isinstance(tw_dev, jnp.ndarray) and tw_dev.shape == (531, 5)
    np.testing.assert_allclose(
        np.asarray(tw_dev, dtype=np.float64).T, twister, rtol=0, atol=1e-6
    )


def test_ca_device_phi_handoff(mesh):
    """phi='device' returns the twister as device-resident [K, d] rows in
    table order — serving params built from it must classify identically to
    the host-twister route (the train-to-serve handoff path)."""
    import jax.numpy as jnp

    from kpop_tpu.parallel.sharded import ca_fit_sharded

    rng = np.random.default_rng(8)
    table = rng.random((97, 6)) * 10.0
    c1, i1, tw_host, sv1 = ca_fit_sharded(mesh, table)
    c2, i2, tw_dev, sv2 = ca_fit_sharded(mesh, table, phi="device")
    assert isinstance(tw_dev, jnp.ndarray) and tw_dev.shape == (97, 5)
    np.testing.assert_allclose(
        np.asarray(tw_dev, dtype=np.float64).T, tw_host, rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(c1, c2, rtol=0, atol=0)
    # fast path too
    _c, _i, tw_dev_f, _s = ca_fit_sharded(
        mesh, table, precision="fast", phi="device"
    )
    assert tw_dev_f.shape == (97, 5)
