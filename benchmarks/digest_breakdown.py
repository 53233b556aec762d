"""Device digest micro-benchmark at the relatedness shape.

Times the fused distance+digest jit and its pieces (distance only,
distance+sort, distance+top_k) device-only, steady state, per
[2048, 10000] batch of the kpop-twistdb -s digest (ops/summaries.py).
Refuses to run without a GPU; prints one JSON record naming the device.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from kpop_tpu.config import jax_setup

jax = jax_setup()
if jax.devices()[0].platform != "gpu":
    sys.exit("digest_breakdown: needs an NVIDIA GPU")
import jax.numpy as jnp
from functools import partial
from kpop_tpu.ops.summaries import _digest_batch, _distance_block

T, D, B = 10000, 512, 2048
rng = np.random.default_rng(4)
t0 = time.perf_counter()


def lg(m):
    sys.stderr.write("[%6.1fs] %s\n" % (time.perf_counter() - t0, m))
    sys.stderr.flush()


targets = jnp.asarray(rng.standard_normal((T, D)), jnp.float32)
queries = jnp.asarray(rng.standard_normal((B, D)), jnp.float32)
metric = jnp.full((D,), 1.0 / D, jnp.float32)
tnorms = jnp.ones((T,), jnp.float32)
statics = dict(kind="euclidean", power=2.0, normalize=True, k_cap=16)
lg("staged; compiling variants")


@partial(jax.jit, static_argnames=("mode",))
def variant(a, b, m, tn, mode):
    bb = b / jnp.sqrt((b * b * m[None, :]).sum(axis=1))[:, None]
    aa = a / tn[:, None]
    dmat = _distance_block(aa, bb, m, "euclidean", 2.0)
    if mode == "dist":
        return dmat.sum()
    if mode == "sort":
        return jnp.sort(dmat, axis=1).sum()
    if mode == "topk":
        nt, idx = jax.lax.top_k(-dmat, 16)
        return nt.sum() + idx.sum()
    raise ValueError(mode)


def timeit(fn, n=20):
    jax.block_until_ready(fn())  # warm
    t0 = time.perf_counter()
    outs = [fn() for _ in range(n)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / n * 1e3


dev = jax.devices()[0]
res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                  "count": len(jax.devices())}}
res["full_digest_ms"] = timeit(
    lambda: _digest_batch(targets, queries, metric, tnorms, **statics)[0]
)
lg("full done")
res["dist_only_ms"] = timeit(lambda: variant(targets, queries, metric, tnorms, "dist"))
lg("dist done")
res["dist_sort_ms"] = timeit(lambda: variant(targets, queries, metric, tnorms, "sort"))
lg("sort done")
res["dist_topk_ms"] = timeit(lambda: variant(targets, queries, metric, tnorms, "topk"))
lg("topk done")
res["queries_per_s_device_only"] = round(B / res["full_digest_ms"] * 1e3, 1)
print(json.dumps(res, indent=1))
