"""The device CA's wire dtypes: the table travels in the smallest dtype
that holds it exactly, and the float64 CA on the device matches the host
float64 CA to float64 tolerances whatever the wire."""

import numpy as np
import pytest

from kpop_tpu.core.ca import fit_ca


@pytest.fixture(scope="module")
def mesh():
    from kpop_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


def test_ca_compact_integer_table_tight(mesh):
    """Integer counts take the compact u16 wire path and still match the
    host float64 CA to tight float64 tolerances."""
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(3)
    table = rng.integers(0, 3000, size=(514, 9)).astype(np.float64)
    want = fit_ca(table)
    coords, inertia, twister, sv = sharded.ca_fit_sharded(mesh, table)
    assert sharded.LAST_CA_WIRE == "u16"
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-8)
    np.testing.assert_allclose(inertia, want.inertia, rtol=0, atol=1e-8)
    np.testing.assert_allclose(coords, want.sample_coords, rtol=0, atol=1e-6)
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=1e-5)


def test_ca_compact_wire_dtypes(mesh):
    """u8 / f32 / f64 wire dtypes are selected by content."""
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(4)
    small = rng.integers(0, 200, size=(130, 6)).astype(np.float64)
    sharded.ca_fit_sharded(mesh, small)
    assert sharded.LAST_CA_WIRE == "u8"
    f32t = (rng.random((130, 6)) * 5).astype(np.float32)
    sharded.ca_fit_sharded(mesh, f32t)
    assert sharded.LAST_CA_WIRE == "f32"
    inexact = rng.random((130, 6)) * 5  # float64, not f32-exact
    sharded.ca_fit_sharded(mesh, inexact)
    assert sharded.LAST_CA_WIRE == "f64"


def test_ca_compact_col_weights(mesh):
    """Integer table + col_weights == host CA of the weighted table, on the
    compact path (weights folded into beta, not applied to the table)."""
    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(5)
    table = rng.integers(0, 40000, size=(301, 7)).astype(np.int64)
    w = 1.0 / table.sum(axis=0)
    want = fit_ca(table.astype(np.float64) * w[None, :])
    coords, inertia, twister, sv = sharded.ca_fit_sharded(
        mesh, table, col_weights=w
    )
    assert sharded.LAST_CA_WIRE == "u16"
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-8)
    np.testing.assert_allclose(coords, want.sample_coords, rtol=0, atol=1e-6)
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=1e-5)
    # the f64 wire honors weights identically
    c2, _i, t2, s2 = sharded.ca_fit_sharded(
        mesh, table.astype(np.float64) + 1e-9, col_weights=w
    )
    assert sharded.LAST_CA_WIRE == "f64"
    np.testing.assert_allclose(s2, sv, rtol=0, atol=1e-7)
    np.testing.assert_allclose(c2, coords, rtol=0, atol=1e-6)


def test_ca_compact_device_phi(mesh):
    """phi='device' on the compact path: device twister matches host."""
    import jax.numpy as jnp

    from kpop_tpu.parallel import sharded

    rng = np.random.default_rng(6)
    table = rng.integers(0, 300, size=(97, 6)).astype(np.float64)
    _c, _i, tw_host, _s = sharded.ca_fit_sharded(mesh, table)
    _c, _i, tw_dev, _s = sharded.ca_fit_sharded(mesh, table, phi="device")
    assert sharded.LAST_CA_WIRE == "u16"
    assert isinstance(tw_dev, jnp.ndarray) and tw_dev.shape == (97, 5)
    np.testing.assert_allclose(
        np.asarray(tw_dev, dtype=np.float64).T, tw_host, rtol=0, atol=1e-6
    )


def test_residual_is_float64_and_matches_host():
    """The device residual S = x*alpha*beta - u v is computed in float64
    under the CA's scoped 64-bit mode, from a compact table block."""
    import jax

    from kpop_tpu.parallel.sharded import _residual

    rng = np.random.default_rng(7)
    x = rng.integers(0, 200, size=(33, 5)).astype(np.uint8)
    alpha, u = rng.random(33) + 0.5, rng.random(33)
    beta, v = (rng.random(5) + 0.5) * 1e-4, rng.random(5)
    with jax.enable_x64(True):
        got = jax.jit(_residual)(x, alpha, u, beta, v)
    assert got.dtype == np.float64
    want = x * alpha[:, None] * beta[None, :] - np.outer(u, v)
    # float64 rounding of the two products and the difference
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=4e-16 * np.abs(want).max())


def test_gram_local_matches_host_float64():
    """Blocked float64 Gram (ragged last block, padded rows contribute
    nothing) equals the host float64 S^T S plus the carried-in sum."""
    import jax

    from kpop_tpu.parallel.sharded import _gram_local

    rng = np.random.default_rng(8)
    x = rng.integers(0, 60000, size=(101, 4)).astype(np.uint16)
    alpha, u = rng.random(101) + 0.5, rng.random(101)
    beta, v = (rng.random(4) + 0.5) * 1e-6, rng.random(4)
    acc0 = rng.random((4, 4))
    with jax.enable_x64(True):
        got = jax.jit(_gram_local, static_argnames="n_blocks")(
            x, alpha, u, beta, v, acc0, n_blocks=7)
    S = x * alpha[:, None] * beta[None, :] - np.outer(u, v)
    np.testing.assert_allclose(np.asarray(got), acc0 + S.T @ S,
                               rtol=1e-13, atol=0)
