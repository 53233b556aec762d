"""The f32 matmuls of the served paths ask for Precision.HIGHEST, read
from their jaxprs: on GPUs the default precision runs f32 operands in
TF32, which the host-parity tolerances do not allow."""

import numpy as np
import pytest

def _dot_precisions(fn, *args):
    import jax

    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                if hasattr(v, "eqns"):
                    walk(v)
                elif hasattr(v, "jaxpr"):
                    walk(v.jaxpr)

    walk(jaxpr.jaxpr)
    return out


def _params(dtype=np.float32):
    import jax.numpy as jnp

    from kpop_tpu.ops.pipeline import ClassifierParams

    rng = np.random.default_rng(0)
    V, d, C, k = 64, 8, 5, 3
    lut = np.full(4**k + 1, V, np.int32)
    lut[:V] = np.arange(V)
    return ClassifierParams(
        jnp.asarray(lut), jnp.asarray(rng.random((V, d)), dtype),
        jnp.full((d,), 1.0 / d, jnp.float32),
        jnp.asarray(rng.random((C, d)), jnp.float32),
        jnp.ones((C,), jnp.float32), k, True,
    )


@pytest.mark.parametrize("step", ["project", "distances_to_classes",
                                  "distance_block", "sharded_serving"])
def test_serving_dots_are_highest(step):
    import jax
    import jax.numpy as jnp

    from kpop_tpu.ops import pipeline
    from kpop_tpu.ops.summaries import _distance_block

    p = _params()
    hi = jax.lax.Precision.HIGHEST
    if step == "project":
        precs = _dot_precisions(pipeline.project, p, jnp.ones((2, 64)))
    elif step == "distances_to_classes":
        precs = _dot_precisions(pipeline.distances_to_classes, p,
                                jnp.ones((2, 8)))
    elif step == "distance_block":
        precs = _dot_precisions(
            lambda a, b, m: _distance_block(a, b, m, "euclidean", 2.0),
            jnp.ones((4, 8)), jnp.ones((2, 8)), jnp.ones((8,)))
    else:
        from kpop_tpu.parallel.mesh import make_mesh
        from kpop_tpu.parallel.serving import (
            shard_classifier_params,
            sharded_dmat_fn,
        )

        mesh = make_mesh(2, data_parallel=1)
        sp, v = shard_classifier_params(p, mesh)
        fn = sharded_dmat_fn(mesh, v)
        precs = _dot_precisions(fn, sp, jnp.zeros((2, 16), jnp.int8))
    assert precs and all(pr == (hi, hi) for pr in precs), precs


def test_bf16_twister_keeps_bf16_operands():
    import jax
    import jax.numpy as jnp

    from kpop_tpu.ops import pipeline

    p = _params(jnp.bfloat16)
    jaxpr = jax.make_jaxpr(pipeline.project)(p, jnp.ones((2, 64)))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert all(v.aval.dtype == jnp.bfloat16 for v in e.invars)
        assert e.outvars[0].aval.dtype == jnp.float32
