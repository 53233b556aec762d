#!/usr/bin/env python3
"""Benchmark: the real pipeline, trained then served on one GPU, on a hard
corpus.  Every phase runs in this one process and prints one JSON line
naming the device; nothing is written into the tree.

- corpus (host): a SARS-CoV-2-shaped phylogeny (tests/data/phylo.py):
  512 sibling classes of 30 kb genomes with within-class divergence
  comparable to between-class (the README.md:1083-1085 difficulty).  Half
  of each clade's tips train the per-class spectra ([K_vocab, 512] table,
  k=10); the other half are held out for serving.
- ca_train: the sharded float64 CA on the device
  (parallel/sharded.py::ca_fit_sharded), twister kept on the device.
- serving: the held-out tips as ART-shaped read sets through the fused
  count -> project -> classify step; top-1 accuracy over every held-out
  tip, then a timed pass including FASTA parse, host encode, 2-bit pack,
  host->device transfer and the device pipeline.
- serving_bf16, ca_train_streamed, large_vocab_serving, relatedness,
  large_k_counting: the bf16 twister, the budgeted streamed CA, a k=12
  2M-row vocabulary, the device digest of kpop-twistdb -s, and host
  counting at k=18.

Refuses to run without a GPU: a number from another device is not this
benchmark's.  Usage: ``python bench.py``.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 10
N_CLASSES = 512
GENOME_LEN = 30_000
BATCH = 128
N_BATCHES = 12


def _phylo():
    spec = importlib.util.spec_from_file_location(
        "kpop_bench_phylo", os.path.join(REPO, "tests", "data", "phylo.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, jax):
        self.jax = jax
        dev = jax.devices()[0]
        self.device = {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        }
        self.t0 = time.perf_counter()

    def log(self, msg: str) -> None:
        sys.stderr.write(
            "bench[%7.1fs]: %s\n" % (time.perf_counter() - self.t0, msg)
        )
        sys.stderr.flush()

    def emit(self, record: str, **fields) -> None:
        print(json.dumps({"record": record, "device": self.device, **fields}),
              flush=True)


def _bench_large_k_counting(b: Bench) -> None:
    """Host-side record: k=18 sparse counting (the reference counts any
    k <= 30 at hash speed, bin/KPopCount.ml:111-123).  Measures the native
    open-addressing hash vs the pure-numpy merge on the same workload."""
    from kpop_tpu import native
    from kpop_tpu.core import count as count_mod
    from kpop_tpu.core.kmers import KmerSpace

    if not native.available():
        return
    rng = np.random.default_rng(1)
    n_reads, L, k = 96, 30_000, 18
    seqs = [
        "".join(rng.choice(list("ACGT"), size=L)) for _ in range(n_reads)
    ]
    space = KmerSpace("DNA-ds", k)

    def run(use_native: bool) -> tuple:
        acc = count_mod.SpectrumAccumulator(space, use_native=use_native)
        enc = count_mod.content_encoder(space.content)
        sparse = count_mod._native_sparse_counter(space) if use_native else None
        t0 = time.perf_counter()
        for s in seqs:
            if sparse is not None and acc.native_hash is not None:
                sparse(s, acc)
            else:
                acc.add(space.window_codes(enc(s)))
        codes, counts = acc.nonzero()
        dt = time.perf_counter() - t0
        return dt, (codes.tobytes(), counts.tobytes())

    t_nat, digest_nat = run(True)
    t_np, digest_np = run(False)
    if digest_nat != digest_np:
        raise RuntimeError("large-k counting parity failure")
    b.emit(
        "large_k_counting", k=k,
        workload="%d x %d kb reads (one -l spectrum)" % (n_reads, L // 1000),
        native_mbases_per_s=n_reads * L / t_nat / 1e6,
        numpy_mbases_per_s=n_reads * L / t_np / 1e6,
    )


def _bench_relatedness(b: Bench) -> None:
    """The relatedness engine (README.md:1049-1073): the blocked device
    digest that `kpop-twistdb --backend jax -s` runs, at 10^5 queries x
    10^4 targets x 512 dims, beside the float64 host path on a subset (per
    query cost is linear in queries, so rates compare directly)."""
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import Distance, summarize_rowwise
    from kpop_tpu.ops.summaries import summarize_rowwise_device

    Q, T, D = 100_000, 10_000, 512
    rng = np.random.default_rng(2)
    dims = ["Dim%d" % (i + 1) for i in range(D)]
    targets = NamedMatrix(
        ["t%d" % i for i in range(T)], dims, rng.standard_normal((T, D))
    )
    queries = NamedMatrix(
        ["q%d" % i for i in range(Q)], dims, rng.standard_normal((Q, D))
    )
    metric = np.full(D, 1.0 / D)
    dist = Distance.of_string("euclidean")
    b.log("relatedness: %d queries x %d targets x %d dims" % (Q, T, D))
    sub0 = NamedMatrix(queries.row_names[:2048], dims, queries.data[:2048])
    t0 = time.perf_counter()
    summarize_rowwise_device(
        dist, metric, targets, sub0, keep_at_most=2, normalize=True,
        out=io.StringIO(), batch=2048,
    )
    compile_s = time.perf_counter() - t0
    out = io.StringIO()
    t0 = time.perf_counter()
    n = summarize_rowwise_device(
        dist, metric, targets, queries, keep_at_most=2, normalize=True,
        out=out, batch=2048,
    )
    dev_s = time.perf_counter() - t0
    if n != Q:
        raise RuntimeError("relatedness wrote %d of %d rows" % (n, Q))
    Qh = max(256, Q // 50)
    sub = NamedMatrix(queries.row_names[:Qh], dims, queries.data[:Qh])
    t0 = time.perf_counter()
    summarize_rowwise(dist, metric, targets, sub, 2, True)
    host_s = time.perf_counter() - t0
    b.emit(
        "relatedness", queries=Q, targets=T, dims=D,
        device_queries_per_s=Q / dev_s, host_queries_per_s=Qh / host_s,
        summary_bytes=out.tell(), wall_s=dev_s, first_batch_s=compile_s,
    )


def main() -> int:
    from kpop_tpu.config import jax_setup

    jax = jax_setup()
    if jax.devices()[0].platform != "gpu":
        sys.stderr.write(
            "bench: needs an NVIDIA GPU; JAX found %r\n"
            % jax.devices()[0].platform
        )
        return 2
    import jax.numpy as jnp

    from kpop_tpu import native
    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.core.space import Distance, Metric, normalizations
    from kpop_tpu.ops.encode import unpack_2bit_batch
    from kpop_tpu.ops.pipeline import (
        ClassifierParams,
        count_spectra,
        distances_to_classes,
        project,
        summarize_batch,
    )
    from kpop_tpu.parallel import sharded
    from kpop_tpu.parallel.mesh import make_mesh

    b = Bench(jax)
    rng = np.random.default_rng(0)
    phylo = _phylo()
    space = KmerSpace("DNA-ds", K)
    t0 = time.perf_counter()
    vocab, table, held_out = phylo.class_corpus(
        rng, space.window_codes, N_CLASSES, GENOME_LEN
    )
    b.emit("corpus", vocab=int(table.shape[0]), classes=N_CLASSES,
           held_out_tips=len(held_out), seconds=time.perf_counter() - t0)

    # ---- CA training, twister kept on the device ----
    mesh = make_mesh()
    csums = table.sum(axis=0)
    col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    t0 = time.perf_counter()
    coords, inertia, phi_dev, sv = sharded.ca_fit_sharded(
        mesh, table, col_weights=col_w, phi="device"
    )
    jax.block_until_ready(phi_dev)
    b.emit("ca_train", table_shape=list(table.shape),
           wire=sharded.LAST_CA_WIRE, wall_s_cold=time.perf_counter() - t0)

    # ---- serving parameters around the device-resident twister ----
    mvec = Metric.of_string("powers(1,1,2)").compute(inertia)
    cls_norms = normalizations(Distance.of_string("euclidean"), mvec, coords)
    lut = np.full(space.n_kmers + 1, len(vocab), dtype=np.int32)
    lut[vocab.astype(np.int64)] = np.arange(len(vocab), dtype=np.int32)

    def params_of(tw):
        return ClassifierParams(
            vocab_lut=jnp.asarray(lut),
            twister=tw,
            metric=jnp.asarray(mvec, jnp.float32),
            class_coords=jnp.asarray(coords.astype(np.float32)),
            class_norms=jnp.asarray(cls_norms.astype(np.float32)),
            k=K,
            canonical=True,
        )

    params = params_of(phi_dev.astype(jnp.float32))

    # ---- queries: held-out tips as ART-shaped read sets (150 bp pairs,
    # ~1x coverage, 0.2% errors), one FASTA record each, 'N' between reads
    perm = rng.permutation(len(held_out))
    eval_batches = []  # (truth [B], fasta bytes) over every held-out tip
    max_len = 0
    for b0 in range(0, len(held_out) - BATCH + 1, BATCH):
        tips = [held_out[j] for j in perm[b0 : b0 + BATCH]]
        records = []
        for i, (_c, g) in enumerate(tips):
            r1, r2 = phylo.sim_paired_reads(rng, g.astype(np.int64),
                                            coverage=1.0)
            seq = "N".join(r1 + r2)
            max_len = max(max_len, len(seq))
            records.append(b">seq%d\n%s\n" % (i, seq.encode()))
        eval_batches.append(
            (np.array([c for c, _ in tips], dtype=np.int64), b"".join(records))
        )
    Lq = -(-max_len // 256) * 256  # fixed jit width for every batch
    payload = eval_batches[0][1]
    if not native.available():
        raise RuntimeError("bench needs the native host library")

    @jax.jit
    def step(p, packed, valid):
        dmat = distances_to_classes(
            p, project(p, count_spectra(p, unpack_2bit_batch(packed, valid, Lq)))
        )
        _mean, _std, _med, _mad, top, idx = summarize_batch(dmat, 2)
        return idx, top

    def encode_and_dispatch(p, pl: bytes = payload):
        codes, _names, _lens, _used = native.fasta_encode_batch(pl, BATCH, Lq)
        packed, valid = native.pack_2bit_batch(codes)
        return step(p, jnp.asarray(packed), jnp.asarray(valid))

    def accuracy(p) -> float:
        correct = total = 0
        for truth, pl in eval_batches:
            out = jax.device_get(encode_and_dispatch(p, pl))
            correct += int((np.asarray(out[0])[:, 0] == truth).sum())
            total += len(truth)
        return correct / total

    def timed_pass(p) -> float:
        t0 = time.perf_counter()
        outs = [encode_and_dispatch(p) for _ in range(N_BATCHES)]
        jax.device_get(outs)
        return N_BATCHES * BATCH / (time.perf_counter() - t0)

    for name, p in (("serving", params),
                    ("serving_bf16", params_of(phi_dev.astype(jnp.bfloat16)))):
        t0 = time.perf_counter()
        jax.device_get(encode_and_dispatch(p))
        first_s = time.perf_counter() - t0
        acc = accuracy(p)
        b.emit(name, k=K, classes=N_CLASSES, vocab=int(table.shape[0]),
               dims=len(sv), batch=BATCH, top1=acc,
               read_sets=len(eval_batches) * BATCH, first_batch_s=first_s,
               seqs_per_s=max(timed_pass(p) for _ in range(2)))

    # ---- the same fit through the budgeted streamed path ----
    nk, ns = table.shape
    budget = int(nk * (ns + (ns - 1) * 4) / mesh.devices.size // 4)
    t0 = time.perf_counter()
    c_s, i_s, tw_s, _sv = sharded.ca_fit_sharded(
        mesh, table, col_weights=col_w, hbm_bytes=budget, phi="device"
    )
    jax.block_until_ready(tw_s)
    b.emit("ca_train_streamed", wall_s=time.perf_counter() - t0,
           budget_bytes_per_device=budget, stream=sharded.LAST_CA_STREAM,
           inertia_max_abs_diff_vs_resident=float(np.abs(i_s - inertia).max()))
    del tw_s

    # ---- serving at a 2M-row k=12 vocabulary (the TB classifier's
    # vocabulary scale, README.md:530); twister values are synthetic ----
    k2, V2, d2 = 12, 2_000_000, 512
    space2 = KmerSpace("DNA-ds", k2)
    big = rng.integers(0, 4, size=6_000_000).astype(np.int8)
    uniq = np.unique(space2.window_codes(big))[:V2]
    lut2 = np.full(space2.n_kmers + 1, V2, dtype=np.int32)
    lut2[uniq.astype(np.int64)] = np.arange(V2, dtype=np.int32)

    @jax.jit
    def make_tw():
        r = jax.lax.broadcasted_iota(jnp.int32, (V2, d2), 0)
        c = jax.lax.broadcasted_iota(jnp.int32, (V2, d2), 1)
        return ((r * 37 + c * 11) % 1009).astype(jnp.float32) * 1e-3

    params_big = ClassifierParams(
        vocab_lut=jnp.asarray(lut2),
        twister=make_tw(),
        metric=jnp.full((d2,), 1.0 / d2, jnp.float32),
        class_coords=jnp.asarray(
            rng.standard_normal((N_CLASSES, d2)).astype(np.float32)),
        class_norms=jnp.ones((N_CLASSES,), jnp.float32),
        k=k2,
        canonical=True,
    )
    offs = rng.integers(0, len(big) - GENOME_LEN, size=64)
    cb = jnp.asarray(np.stack([big[o : o + GENOME_LEN] for o in offs]))

    @jax.jit
    def step_big(p, codes):
        return summarize_batch(
            distances_to_classes(p, project(p, count_spectra(p, codes))), 2)

    jax.block_until_ready(step_big(params_big, cb))
    t0 = time.perf_counter()
    jax.block_until_ready([step_big(params_big, cb) for _ in range(10)])
    b.emit("large_vocab_serving", vocab_rows=V2, dims=d2, k=k2,
           device_only_seqs_per_s=10 * 64 / (time.perf_counter() - t0))
    del params_big

    _bench_relatedness(b)
    _bench_large_k_counting(b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
