#!/usr/bin/env python3
"""Flagship-envelope record: stream-fit CA on the FULL k=12 vocabulary.

The reference's biggest workload is a k=12 classifier DB of ~16.7M k-mers
x ~1,000 samples (/root/reference/README.md:530,1023-1029), factored by R's
``ca()`` bounded only by host RAM (/root/reference/src/KPopTwist:95-96).
The full-dim phi alone is ~67 GB in f32, so this fits ``n_dims`` leading
dimensions with ``phi="device"`` (streamed through
parallel/sharded.py::_ca_fit_streamed when the table exceeds the device
budget, or when ``KPOP_FLAGSHIP_HBM`` sets a smaller one), then classifies
a batch straight through the device-resident ``[16.7M, n_dims]`` twister
— train-to-serve at the reference's flagship table shape on one GPU.

Counts are synthetic (uniform u8, ~25% density): this is a shape/wall/
residency record; value parity of the streamed path is covered by
tests/test_ca_streamed.py (including n_dims truncation) at CI scale.

Prints one JSON record naming the device; refuses to run without a GPU.
Env knobs: KPOP_FLAGSHIP_NK / _NS / _DIMS / _HBM (per-device CA budget,
bytes; default the device's) / _B / _L.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("KPOP_CA_DEBUG", "1")  # per-phase walls on stderr

import numpy as np


class _Tee:
    """Forward stderr while capturing it (the KPOP_CA_DEBUG phase lines
    become the JSON record's phases_s)."""

    def __init__(self, inner):
        self.inner = inner
        self.chunks: list[str] = []

    def write(self, s):
        self.chunks.append(s)
        return self.inner.write(s)

    def flush(self):
        self.inner.flush()

    def captured(self) -> str:
        return "".join(self.chunks)


def main() -> None:
    from kpop_tpu.config import jax_setup

    jax = jax_setup()
    import jax.numpy as jnp

    from kpop_tpu.parallel import sharded
    from kpop_tpu.parallel.mesh import make_mesh

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("flagship_ca: needs an NVIDIA GPU; JAX found %r" % dev.platform)
    env = os.environ.get
    NK = int(env("KPOP_FLAGSHIP_NK", str(4**12)))
    NS = int(env("KPOP_FLAGSHIP_NS", "1000"))
    DIMS = int(env("KPOP_FLAGSHIP_DIMS", "64"))
    HBM = int(float(env("KPOP_FLAGSHIP_HBM", "0"))) or None
    B = int(env("KPOP_FLAGSHIP_B", "16"))
    L = int(env("KPOP_FLAGSHIP_L", "30000"))

    def log(msg):
        sys.stderr.write("flagship[%7.1fs]: %s\n" % (time.perf_counter() - T0, msg))
        sys.stderr.flush()

    T0 = time.perf_counter()
    rng = np.random.default_rng(12)
    log("building %d x %d u8 table (%.1f GB host)" % (NK, NS, NK * NS / 2**30))
    table = np.empty((NK, NS), np.uint8)
    step = max(1, (256 << 20) // NS)
    for i in range(0, NK, step):
        blk = rng.integers(
            0, 256, size=(min(step, NK - i), NS), dtype=np.uint8
        )
        # keep bytes < 64 as counts (values 1..63, ~25% density), else zero
        table[i : i + blk.shape[0]] = np.where(blk < 64, blk, 0)
    gen_s = time.perf_counter() - T0
    log("table built in %.1f s" % gen_s)
    colsums = table.sum(axis=0, dtype=np.float64)
    col_w = 1.0 / np.where(colsums == 0.0, 1.0, colsums)

    mesh = make_mesh()
    tee = _Tee(sys.stderr)
    sys.stderr = tee
    try:
        t0 = time.perf_counter()
        coords, inertia, tw_dev, sv = sharded.ca_fit_sharded(
            mesh, table, n_dims=DIMS, col_weights=col_w,
            hbm_bytes=HBM, phi="device", verbose=True,
        )
        fit_s = time.perf_counter() - t0
    finally:
        sys.stderr = tee.inner
    stream = dict(sharded.LAST_CA_STREAM or {})
    import re

    phases = {
        m.group(1): float(m.group(2))
        for m in re.finditer(
            r"ca_fit_sharded\[(.+?)\]: ([\d.]+) s", tee.captured()
        )
    }
    log("fit done %.1f s (%s blocks of %s rows, wire=%s)"
        % (fit_s, stream.get("n_blocks"), stream.get("block_rows"),
           stream.get("wire")))

    # ---- serve straight from the device-resident twister ----
    # identity LUT: synthetic table row i IS k-mer code i, so every
    # canonical window code maps to its own twister row
    from kpop_tpu.core.space import Distance, normalizations
    from kpop_tpu.ops.pipeline import (
        ClassifierParams,
        count_spectra,
        distances_to_classes,
        project,
        summarize_batch,
    )

    # k from the vocabulary size: the identity LUT only covers the code
    # space when NK == 4^k
    k_eff = round(np.log(NK) / np.log(4))
    assert 4**k_eff == NK, "KPOP_FLAGSHIP_NK must be a power of 4"
    lut = np.empty(NK + 1, dtype=np.int32)
    lut[:NK] = np.arange(NK, dtype=np.int32)
    lut[NK] = NK  # trash row
    metric = np.full(DIMS, 1.0 / DIMS)
    cls_norms = normalizations(
        Distance.of_string("euclidean"), metric, coords
    )
    params = ClassifierParams(
        vocab_lut=jnp.asarray(lut),
        twister=tw_dev,
        metric=jnp.asarray(metric, jnp.float32),
        class_coords=jnp.asarray(coords.astype(np.float32)),
        class_norms=jnp.asarray(cls_norms.astype(np.float32)),
        k=k_eff,
        canonical=True,
    )

    from kpop_tpu.ops.pipeline import project_reads

    def _step(p, base_codes):
        spectra = count_spectra(p, base_codes)
        twisted = project(p, spectra)
        dmat = distances_to_classes(p, twisted)
        _mean, _std, _med, _mad, top, idx = summarize_batch(dmat, 2)
        return idx, top

    def _step_bag(p, base_codes):
        # the --project-path bag route: no [B, V] spectrum, no full
        # twister read per batch
        dmat = distances_to_classes(p, project_reads(p, base_codes))
        _mean, _std, _med, _mad, top, idx = summarize_batch(dmat, 2)
        return idx, top

    step_fn = jax.jit(_step)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    cd = jnp.asarray(codes)
    log("serving probe compile")
    t0 = time.perf_counter()
    first = jax.device_get(step_fn(params, cd))
    serve_compile_s = time.perf_counter() - t0
    n_iter = 10
    t0 = time.perf_counter()
    outs = [step_fn(params, cd) for _ in range(n_iter)]
    jax.device_get(outs[-1])
    serve_s = time.perf_counter() - t0
    rate = n_iter * B / serve_s
    assert np.asarray(first[0]).shape == (B, 2)
    log("serving %.1f seqs/s device-only at the full-vocab twister" % rate)
    bag_fn = jax.jit(_step_bag)
    B2 = 4 * B
    cd2 = jnp.asarray(rng.integers(0, 4, size=(B2, L)).astype(np.int8))
    t0 = time.perf_counter()
    first_bag = jax.device_get(bag_fn(params, cd2))
    bag_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [bag_fn(params, cd2) for _ in range(n_iter)]
    jax.device_get(outs[-1])
    bag_rate = n_iter * B2 / (time.perf_counter() - t0)
    assert np.asarray(first_bag[0]).shape == (B2, 2)
    log("serving (bag, B=%d) %.1f seqs/s device-only" % (B2, bag_rate))
    # prediction parity between the two projection routes (same [B, L]
    # shape as the compiled dense step, so no extra compile)
    dense_on_bag = jax.device_get(step_fn(params, cd2[:B]))
    bag_matches = float(
        (np.asarray(dense_on_bag[0])[:, 0]
         == np.asarray(first_bag[0])[:B, 0]).mean()
    )

    print(json.dumps({
        "record": "flagship_ca",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "table_shape": [NK, NS],
        "n_dims": DIMS,
        "budget_bytes_per_device": HBM,
        "table_gen_s": gen_s,
        "wall_s_fit": fit_s,
        "phases_s": phases,
        "stream": stream,
        "inertia_kept_sum": float(inertia.sum()),
        "dense_B%d_seqs_per_s" % B: rate,
        "dense_compile_s": serve_compile_s,
        "bag_B%d_seqs_per_s" % B2: bag_rate,
        "bag_compile_s": bag_compile_s,
        "bag_top1_matches_dense": bag_matches,
    }), flush=True)


if __name__ == "__main__":
    main()
