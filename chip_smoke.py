#!/usr/bin/env python3
"""Smoke run of kpop-tpu on NVIDIA GPUs at the SARS-CoV-2 lineage
classifier's width: k = 10, 1,636 classes, all 1,635 CA dimensions, ~30 kb
genomes (the upstream README's classifier, BASELINE.md).

One process drives the users' entry points in turn:

- ``ca``:     ``kpop-twist --backend jax`` on a 128-class table against
              the host float64 CA, then on the full table;
- ``serve``:  ``kpop-classify`` on held-out read sets with the trained
              artifacts, against the host float64 chain on a subset;
- ``relate``: ``kpop-twistdb --backend jax -s`` on seeded twisted queries
              against the trained classes, against the host summaries;
- ``kernel``: the distance block (XLA matmul expansion) at the twisted and
              the raw-spectrum widths, against host float64.

``--four`` runs only the four-card phase: ``kpop-twist`` on a four-device
mesh and ``kpop-classify --kmer-parallel 4``, each against its one-device
result from the same process.

Data come from a seed (``--seed``); weights are trained here.  Only the
number of training tips per class and the number of queries are cut.  Every
phase failure raises, and the run exits non-zero; the last line of standard
output is a JSON object naming the device.  Usage::

    python chip_smoke.py [--four] [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

K = 10
N_CLASSES = 1636
GENOME_LEN = 30_000
TIPS_PER_CLASS = 4  # cut: 2 training + 2 held-out tips per class
SERVE_BATCH = 64
SERVE_QUERIES = 8 * SERVE_BATCH  # cut: 512 held-out read sets
PARITY_QUERIES = 64
CA_SUBSET = 128  # classes in the host float64 CA comparison
RELATE_QUERIES = 16_384  # cut from the deployment's 641,847
RELATE_PARITY = 512
#: [queries, targets, dims] of the distance block at the twisted width and
#: at the raw-spectrum width (all canonical 10-mers) of kpop-countdb
KERNEL_WIDTHS = {
    "twisted": (1024, 16_384, N_CLASSES - 1),
    "raw spectra": (256, N_CLASSES, 524_800),
}
TOL = 2e-4  # relative, floor 1: the device summaries' own criterion
#: the f32 expansion |a|^2 + |b|^2 - 2ab sums D products in f32: its
#: error grows ~sqrt(D) eps, times the cancellation (|a|^2 + |b|^2) / d^2
#: of near neighbours; at D = 524,800 that is ~1e-4, so 1e-3 there
KERNEL_TOL = {"twisted": TOL, "raw spectra": 1e-3}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def close(a, b) -> float:
    """Max of |a - b| / max(1, |b|): the repo's device-vs-host criterion."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def timed(fn, n: int = 5) -> float:
    """Median wall ms of ``fn()`` run to completion, after one warm call."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phylo():
    spec = importlib.util.spec_from_file_location(
        "kpop_smoke_phylo", os.path.join(REPO, "tests", "data", "phylo.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


# ---------------- start-up ----------------


def start(n_devices: int):
    from kpop_tpu.config import jax_setup

    jax = jax_setup()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(
            "chip_smoke: needs NVIDIA GPUs; JAX found %r\n" % devs[0].platform
        )
        sys.exit(2)
    if len(devs) < n_devices:
        sys.stderr.write(
            "chip_smoke: needs %d GPUs, JAX found %d\n" % (n_devices, len(devs))
        )
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    from kpop_tpu import native

    print("gpu: " + " | ".join(smi), flush=True)
    emit(
        "start", device_kind=devs[0].device_kind, device_count=len(devs),
        jax=jax.__version__, native_library=native.available(),
        bytes_limit=devs[0].memory_stats()["bytes_limit"],
    )
    return jax


def cuts(four: bool) -> None:
    queries = ("%d serve queries" % (2 * SERVE_BATCH) if four else
               "%d serve queries; %d relate queries (of 641,847)"
               % (SERVE_QUERIES, RELATE_QUERIES))
    print(
        "cuts: %d training tips + %d held-out tips per class (of a "
        "~650K-genome corpus); %s; k, classes, dims and genome length are "
        "the published ones" % (TIPS_PER_CLASS // 2,
                                TIPS_PER_CLASS - TIPS_PER_CLASS // 2, queries),
        flush=True,
    )


# ---------------- data ----------------


def build_corpus(seed: int, work: str):
    """The class CounterDB (k = 10 canonical, 1,636 classes) on disk, plus
    held-out tips."""
    from kpop_tpu.core.counter_db import CounterDB
    from kpop_tpu.core.kmers import KmerSpace

    t0 = time.perf_counter()
    space = KmerSpace("DNA-ds", K)
    vocab, table, held_out = phylo().class_corpus(
        np.random.default_rng(seed), space.window_codes, N_CLASSES,
        GENOME_LEN, tips_per_class=TIPS_PER_CLASS,
    )
    db = CounterDB(
        row_names=space.codes_to_hex(vocab),
        col_names=["C%d" % (c + 1) for c in range(N_CLASSES)],
        counts=table,
    )
    prefix = os.path.join(work, "Classes")
    db.to_binary(prefix)
    emit("corpus", kmers=int(table.shape[0]), classes=N_CLASSES,
         table_gb_u8=round(table.size / 1e9, 3),
         seconds=round(time.perf_counter() - t0, 1))
    return prefix, db, held_out


def read_sets(seed: int, held_out, n: int, path: str) -> list[int]:
    """``n`` held-out tips as ART-shaped read sets (150 bp pairs, ~1x
    coverage, 0.2% errors), one FASTA record per tip with 'N' between
    reads; returns the true class of each record."""
    ph = phylo()
    rng = np.random.default_rng(seed + 1)
    pick = rng.choice(len(held_out), size=n, replace=False)
    truth = []
    with open(path, "w") as f:
        for i, j in enumerate(pick):
            c, genome = held_out[j]
            r1, r2 = ph.sim_paired_reads(rng, genome.astype(np.int64),
                                         coverage=1.0)
            f.write(">q%d-C%d\n%s\n" % (i, c + 1, "N".join(r1 + r2)))
            truth.append(c + 1)
    return truth


def fasta_records(path: str) -> tuple[list[str], list[str]]:
    names, seqs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                names.append(line[1:].strip())
            else:
                seqs.append(line.strip())
    return names, seqs


def summary_lines(path: str) -> list[list[str]]:
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f]


def compare_summaries(got: list[list[str]], want: list[list[str]]) -> float:
    """Same names, nearest classes and tie groups; returns the numeric
    error under :func:`close`."""
    check(len(got) == len(want), "summary line counts differ")
    err = 0.0
    for g, w in zip(got, want):
        check(g[0] == w[0] and len(g) == len(w),
              "summary structure differs: %s vs %s" % (g[:1], w[:1]))
        check(g[5::3] == w[5::3],
              "nearest classes differ for %s: %s vs %s" % (g[0], g[5::3], w[5::3]))
        num = [i for i in range(1, len(g)) if (i - 5) % 3 != 0 or i < 5]
        err = max(err, close([float(g[i]) for i in num],
                             [float(w[i]) for i in num]))
    return err


# ---------------- phase ca ----------------


def ca_errors(coords, inertia, coords_ref, inertia_ref) -> tuple[float, float]:
    """(max inertia relative error, max abs error of the leading 10
    dimensions' sample coordinates after per-dimension sign alignment)."""
    c, cr = np.asarray(coords)[:, :10], np.asarray(coords_ref)[:, :10]
    signs = np.sign((c * cr).sum(axis=0))
    signs[signs == 0] = 1.0
    in_rel = float((np.abs(inertia - inertia_ref)
                    / np.abs(inertia_ref).max()).max())
    return in_rel, float(np.abs(c - cr * signs).max())


def phase_ca(db, db_prefix: str, work: str) -> str:
    from kpop_tpu.cli import twist
    from kpop_tpu.core.counter_db import CounterDB
    from kpop_tpu.core.twister import Twister, twist_counter_db
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType

    sub = CounterDB(row_names=list(db.row_names),
                    col_names=db.col_names[:CA_SUBSET],
                    counts=np.ascontiguousarray(db.counts[:, :CA_SUBSET]))
    tw_d, twd_d, _ = twist_counter_db(sub, backend="jax")
    tw_h, twd_h, _ = twist_counter_db(sub, backend="host")
    in_rel, c_err = ca_errors(
        twd_d.matrix.data, tw_d.inertia.matrix.data[0],
        twd_h.matrix.data, tw_h.inertia.matrix.data[0],
    )
    check(in_rel <= 1e-6, "CA inertia error %.3g > 1e-6" % in_rel)
    check(c_err <= 1e-5, "CA coordinate error %.3g > 1e-5" % c_err)
    emit("ca", check="kpop-twist --backend jax vs host fit_ca",
         classes=CA_SUBSET, kmers=len(tw_d.kmer_names),
         inertia_rel_err=in_rel, coords10_abs_err=c_err)

    tw_prefix = os.path.join(work, "Trained")
    t0 = time.perf_counter()
    check(twist.main(["-i", db_prefix, "-o", tw_prefix, "--backend", "jax"])
          == 0, "kpop-twist failed")
    wall = time.perf_counter() - t0
    from kpop_tpu.parallel import sharded

    twister = Twister.of_binary(tw_prefix)
    coords = KPopMatrix.of_binary(MatrixType.TWISTED, tw_prefix).matrix.data
    tw = np.asarray(twister.twister.matrix.data)
    inertia = np.asarray(twister.inertia.matrix.data[0])
    d, V = tw.shape
    check(d == N_CLASSES - 1 and V == db.n_rows, "twister shape %s" % (tw.shape,))
    check(np.isfinite(tw).all() and np.isfinite(coords).all(),
          "non-finite twister or coordinates")
    check(abs(inertia.sum() - 1.0) < 1e-9 and (np.diff(inertia) <= 0).all(),
          "inertia does not sum to 1 in descending order")
    # the CA identity that makes projection work: each training column
    # profile projects through the twister onto its class coordinates
    cols = np.arange(0, N_CLASSES, N_CLASSES // 16)
    prof = db.counts[:, cols].astype(np.float64)
    prof /= prof.sum(axis=0)
    proj = (tw[:10] @ prof).T
    id_err = float(np.abs(proj - coords[cols, :10]).max()
                   / np.abs(coords[:, :10]).max())
    check(id_err < 1e-4, "twister identity error %.3g" % id_err)
    emit("ca", check="kpop-twist --backend jax, full table",
         kmers=V, classes=N_CLASSES, dims=d, wire=sharded.LAST_CA_WIRE,
         streamed=sharded.LAST_CA_STREAM is not None,
         identity_rel_err=id_err, wall_s=round(wall, 2))
    return tw_prefix


# ---------------- phase serve ----------------


def host_rows(twister, coords, seqs, space):
    """Host float64 chain: spectra -> Twister.project_entries ->
    distance_rowwise (euclidean, powers(1,1,2))."""
    from kpop_tpu.core.count import spectrum_of_sequences
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import Distance, Metric, distance_rowwise

    entries = []
    for s in seqs:
        cs, vs = spectrum_of_sequences(space, [s])
        entries.append(list(zip(space.codes_to_hex(cs), vs.astype(float))))
    proj = twister.project_entries(entries)
    dims = ["D%d" % i for i in range(coords.shape[1])]
    return distance_rowwise(
        Distance.of_string("euclidean"),
        twister.metrics_vector(Metric.of_string("powers(1,1,2)")),
        NamedMatrix(["c%d" % i for i in range(len(coords))], dims, coords),
        NamedMatrix(["q%d" % i for i in range(len(seqs))], dims, proj),
    ).data


def default_precision_dmat(jax, params, codes):
    """The served dense step with both f32 matmuls at DEFAULT precision
    (TF32 on this card), for the precision-cost line."""
    import jax.numpy as jnp

    from kpop_tpu.ops.pipeline import count_spectra

    @jax.jit
    def step(p, c):
        spectra = count_spectra(p, c)
        sums = spectra.sum(axis=1)
        tw = jnp.dot(spectra, p.twister, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.DEFAULT)
        a = tw / jnp.where(sums == 0, 1.0, sums)[:, None]
        na = jnp.sqrt((a * a * p.metric).sum(axis=1))
        a = a / jnp.where(na == 0, 1.0, na)[:, None]
        b = p.class_coords / p.class_norms[:, None]
        am = a * p.metric
        cross = jnp.dot(am, b.T, precision=jax.lax.Precision.DEFAULT)
        d2 = (am * a).sum(1)[:, None] + (b * b * p.metric).sum(1)[None, :]
        return jnp.sqrt(jnp.maximum(d2 - 2.0 * cross, 0.0))

    return np.asarray(step(params, codes), np.float64)


def encode_batch(seqs: list[str]) -> np.ndarray:
    """As kpop-classify pads a batch: width rounded up to 512, -1 fill."""
    from kpop_tpu.ops.encode import encode_reads_host

    codes = encode_reads_host(seqs)
    w = -(-codes.shape[1] // 512) * 512
    return np.pad(codes, ((0, 0), (0, w - codes.shape[1])), constant_values=-1)


def phase_serve(jax, tw_prefix: str, held_out, seed: int, work: str) -> None:
    import jax.numpy as jnp

    from kpop_tpu.cli import classify
    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType
    from kpop_tpu.core.twister import Twister
    from kpop_tpu.ops.pipeline import build_classifier_params, dmat_bag, dmat_dense

    fasta = os.path.join(work, "queries.fasta")
    truth = read_sets(seed, held_out, SERVE_QUERIES, fasta)
    out = os.path.join(work, "Pred")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = classify.main(["-T", tw_prefix, "-t", tw_prefix, "-f", fasta,
                            "-o", out, "--batch", str(SERVE_BATCH),
                            "-k", str(K), "-v"])
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue()[-2000:])
    check(rc == 0, "kpop-classify failed")
    lines = summary_lines(out + ".KPopSummary.txt")
    check(len(lines) == SERVE_QUERIES, "kpop-classify wrote %d lines" % len(lines))
    pred = [int(ln[5][1:]) for ln in lines]
    acc = float(np.mean(np.array(pred) == np.array(truth)))
    picked = [ln.split()[-1] for ln in err.getvalue().splitlines()
              if "projection path" in ln]
    emit("serve", check="kpop-classify on held-out read sets",
         k=K, classes=N_CLASSES, queries=SERVE_QUERIES, batch=SERVE_BATCH,
         top1=acc, project_path_auto=picked[0] if picked else None,
         wall_s_incl_load_and_compile=round(wall, 2))

    # parity subset against the host float64 chain, on the CLI's own
    # served step (ops/pipeline.dmat_dense / dmat_bag)
    space = KmerSpace("DNA-ds", K)
    twister = Twister.of_binary(tw_prefix)
    coords = np.asarray(
        KPopMatrix.of_binary(MatrixType.TWISTED, tw_prefix).matrix.data)
    params = build_classifier_params(space, twister, coords)
    names, seqs = fasta_records(fasta)
    seqs = seqs[:PARITY_QUERIES]
    codes = jnp.asarray(encode_batch(seqs))
    want = host_rows(twister, coords, seqs, space)
    rows = {"dense": dmat_dense, "bag": dmat_bag}
    for path, fn in rows.items():
        got = np.asarray(fn(params, codes), np.float64)
        rel = float((np.abs(got - want) / np.abs(want)).max())
        check((got.argmin(1) == want.argmin(1)).all(),
              "%s path: predicted classes differ from the host chain" % path)
        check(rel <= TOL, "%s path: distance error %.3g > %g" % (path, rel, TOL))
        emit("serve", check="%s path vs host float64 chain" % path,
             queries=PARITY_QUERIES, max_rel_err=rel,
             warm_batch_ms=timed(lambda: fn(params, codes)))
    got = default_precision_dmat(jax, params, codes)
    emit("serve", info="DEFAULT matmul precision vs host float64 chain",
         max_rel_err=float((np.abs(got - want) / np.abs(want)).max()),
         same_predictions=bool((got.argmin(1) == want.argmin(1)).all()))
    mem = dmat_dense.lower(params, codes).compile().memory_analysis()
    emit("serve", info="memory_analysis of the dense serve step",
         argument_bytes=mem.argument_size_in_bytes,
         output_bytes=mem.output_size_in_bytes,
         temp_bytes=mem.temp_size_in_bytes,
         code_bytes=mem.generated_code_size_in_bytes)


# ---------------- phase relate ----------------


def phase_relate(tw_prefix: str, seed: int, work: str) -> None:
    from kpop_tpu.cli import twistdb
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix
    from kpop_tpu.core.space import Distance, Metric, summarize_rowwise
    from kpop_tpu.core.twister import Twister

    targets = KPopMatrix.of_binary(MatrixType.TWISTED, tw_prefix)
    t = np.asarray(targets.matrix.data)
    rng = np.random.default_rng(seed + 2)
    # queries near the classes: a class's coordinates plus noise on the
    # scale of the class spread
    q = t[rng.integers(0, len(t), RELATE_QUERIES)]
    q = q + rng.standard_normal(q.shape) * t.std(axis=0)[None, :] * 0.5
    qm = NamedMatrix(["r%d" % i for i in range(RELATE_QUERIES)],
                     list(targets.matrix.col_names), q)
    q_prefix = os.path.join(work, "Related")
    KPopMatrix(MatrixType.TWISTED, qm).to_binary(q_prefix)
    out = os.path.join(work, "Relate")
    t0 = time.perf_counter()
    check(twistdb.main(["-i", "T", tw_prefix, "-i", "t", tw_prefix,
                        "--backend", "jax", "-s", q_prefix, out]) == 0,
          "kpop-twistdb -s failed")
    wall = time.perf_counter() - t0
    got = summary_lines(out + ".KPopSummary.txt")
    check(len(got) == RELATE_QUERIES, "kpop-twistdb wrote %d lines" % len(got))
    metric = Twister.of_binary(tw_prefix).metrics_vector(
        Metric.of_string("powers(1,1,2)"))
    sub = NamedMatrix(qm.row_names[:RELATE_PARITY], qm.col_names,
                      q[:RELATE_PARITY])
    want = [ln.split("\t") for ln in summarize_rowwise(
        Distance.of_string("euclidean"), metric, targets.matrix, sub, 2, True)]
    err = compare_summaries(got[:RELATE_PARITY], want)
    check(err <= TOL, "relate numeric error %.3g > %g" % (err, TOL))
    emit("relate", check="kpop-twistdb --backend jax -s vs host summaries",
         queries=RELATE_QUERIES, targets=len(t), dims=t.shape[1],
         parity_queries=RELATE_PARITY, max_rel_err=err,
         wall_s_incl_load_and_compile=round(wall, 2),
         queries_per_s=round(RELATE_QUERIES / wall, 1))


# ---------------- phase kernel ----------------


def phase_kernel(jax, seed: int) -> None:
    """The distance block of kpop-twistdb -d/-s and kpop-countdb
    --distances (ops/summaries._distance_block, XLA matmul expansion) at
    the twisted width and the raw-spectrum width."""
    import jax.numpy as jnp

    from kpop_tpu.ops.summaries import _distance_block

    rng = np.random.default_rng(seed + 3)
    xla = jax.jit(lambda a, b, m: _distance_block(b, a, m, "euclidean", 2.0))
    gens = {
        "twisted": lambda s: rng.standard_normal(s, dtype=np.float32),
        "raw spectra": lambda s: rng.integers(
            0, 4, size=s, dtype=np.int8).astype(np.float32),
    }
    for name, (Q, T, D) in KERNEL_WIDTHS.items():
        gen = gens[name]
        qs, ts = gen((Q, D)), gen((T, D))
        m = np.full(D, 1.0, np.float32) if name != "twisted" else (
            rng.random(D).astype(np.float32) / D)
        qs /= np.sqrt((qs.astype(np.float64) ** 2 * m).sum(1))[:, None]
        ts /= np.sqrt((ts.astype(np.float64) ** 2 * m).sum(1))[:, None]
        qd, td, md = jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(m)
        got = np.asarray(xla(qd, td, md)[:8], np.float64)
        want = np.stack([
            np.sqrt(((ts.astype(np.float64) - qs[i].astype(np.float64)) ** 2
                     * m).sum(1)) for i in range(8)])
        err = close(got, want)
        check(err <= KERNEL_TOL[name],
              "%s distance block error %.3g" % (name, err))
        ms = timed(lambda: xla(qd, td, md), n=10)
        emit("kernel", block=name, shape=[Q, T, D], max_rel_err=err,
             xla_expansion_ms=ms,
             tflops=round(2.0 * Q * T * D / ms / 1e9, 2))
        del qd, td


# ---------------- phase four ----------------


def phase_four(jax, db, db_prefix: str, held_out, seed: int, work: str) -> None:
    from kpop_tpu.cli import classify, twist
    from kpop_tpu.core.counter_db import TableFilter
    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType
    from kpop_tpu.core.space import summarize_distance_row
    from kpop_tpu.core.twister import Twister
    from kpop_tpu.ops.pipeline import build_classifier_params, dmat_dense
    from kpop_tpu.parallel.mesh import make_mesh
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    tw_prefix = os.path.join(work, "Trained4")
    t0 = time.perf_counter()
    check(twist.main(["-i", db_prefix, "-o", tw_prefix, "--backend", "jax"])
          == 0, "kpop-twist failed on four devices")
    wall = time.perf_counter() - t0
    twister = Twister.of_binary(tw_prefix)
    coords = np.asarray(
        KPopMatrix.of_binary(MatrixType.TWISTED, tw_prefix).matrix.data)
    _rows, _cols, table = db.transformed_counts(TableFilter())
    csums = table.sum(axis=0)
    c1, i1, _tw1, _sv1 = ca_fit_sharded(
        make_mesh(1), table, col_weights=1.0 / np.where(csums == 0, 1.0, csums))
    in_rel, c_err = ca_errors(coords, twister.inertia.matrix.data[0], c1, i1)
    check(in_rel <= 1e-6 and c_err <= 1e-5,
          "four-device CA vs one device: inertia %.3g, coords %.3g"
          % (in_rel, c_err))
    emit("four", check="kpop-twist --backend jax on 4 devices vs 1",
         mesh=dict(make_mesh().shape), inertia_rel_err=in_rel,
         coords10_abs_err=c_err, wall_s=round(wall, 2))

    fasta = os.path.join(work, "queries4.fasta")
    read_sets(seed, held_out, 2 * SERVE_BATCH, fasta)
    out = os.path.join(work, "Pred4")
    t0 = time.perf_counter()
    check(classify.main(["-T", tw_prefix, "-t", tw_prefix, "-f", fasta,
                         "-o", out, "--batch", str(SERVE_BATCH), "-k", str(K),
                         "--kmer-parallel", "4"]) == 0,
          "kpop-classify --kmer-parallel 4 failed")
    wall = time.perf_counter() - t0
    got = summary_lines(out + ".KPopSummary.txt")
    # one-device result: the replicated served step on device 0
    params = jax.device_put(
        build_classifier_params(KmerSpace("DNA-ds", K), twister, coords),
        jax.devices()[0])
    names, seqs = fasta_records(fasta)
    class_names = list(KPopMatrix.of_binary(
        MatrixType.TWISTED, tw_prefix).matrix.row_names)
    want = []
    for lo in range(0, len(seqs), SERVE_BATCH):
        rows = np.asarray(dmat_dense(params, jax.device_put(
            encode_batch(seqs[lo:lo + SERVE_BATCH]), jax.devices()[0])),
            np.float64)
        want += [summarize_distance_row(2, n, r, class_names).split("\t")
                 for n, r in zip(names[lo:lo + SERVE_BATCH], rows)]
    err = compare_summaries(got, want)
    check(err <= TOL, "kmer-parallel serving error %.3g" % err)
    emit("four", check="kpop-classify --kmer-parallel 4 vs one device",
         queries=len(seqs), max_rel_err=err,
         wall_s_incl_load_and_compile=round(wall, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    jax = start(n_dev)
    cuts(args.four)
    with tempfile.TemporaryDirectory(prefix="kpop_smoke_") as work:
        db_prefix, db, held_out = build_corpus(args.seed, work)
        if args.four:
            phase_four(jax, db, db_prefix, held_out, args.seed, work)
        else:
            tw_prefix = phase_ca(db, db_prefix, work)
            del db
            phase_serve(jax, tw_prefix, held_out, args.seed, work)
            phase_relate(tw_prefix, args.seed, work)
            phase_kernel(jax, args.seed)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
