"""Checks that need an NVIDIA GPU: they skip elsewhere.  Run them on a card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import io

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_ca_float64_on_the_card(gpu):
    from kpop_tpu.core.ca import fit_ca
    from kpop_tpu.parallel import sharded
    from kpop_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    table = rng.integers(0, 3000, size=(5140, 9)).astype(np.int32)
    want = fit_ca(table.astype(np.float64))
    coords, inertia, twister, sv = sharded.ca_fit_sharded(make_mesh(1), table)
    assert sharded.LAST_CA_WIRE == "u16"
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(coords, want.sample_coords, rtol=0, atol=1e-10)
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=1e-5)


def test_device_summaries_on_the_card(gpu):
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import Distance, summarize_rowwise
    from kpop_tpu.ops.summaries import summarize_rowwise_device

    rng = np.random.default_rng(0)
    D = 1635
    dims = ["d%d" % j for j in range(D)]
    targets = NamedMatrix(["t%d" % i for i in range(300)], dims,
                          rng.standard_normal((300, D)))
    queries = NamedMatrix(["q%d" % i for i in range(70)], dims,
                          rng.standard_normal((70, D)))
    metric = rng.random(D) / D
    dist = Distance.of_string("euclidean")
    want = summarize_rowwise(dist, metric, targets, queries, keep_at_most=2)
    buf = io.StringIO()
    summarize_rowwise_device(dist, metric, targets, queries, keep_at_most=2,
                             normalize=True, out=buf, batch=32)
    for g, w in zip(buf.getvalue().splitlines(), want):
        pg, pw = g.split("\t"), w.split("\t")
        assert pg[0] == pw[0] and pg[5::3] == pw[5::3]
        for a, b in zip(pg[1:], pw[1:]):
            if a.startswith("t"):
                continue
            assert abs(float(a) - float(b)) < 2e-4 * max(1.0, abs(float(b)))
