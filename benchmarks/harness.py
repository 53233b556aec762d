"""Benchmark harness: the BASELINE.json workload configs as runnable
scenarios (SURVEY.md §7 step 8).

Each scenario builds synthetic data shaped like the reference's worked
examples, runs the pipeline end-to-end through the library API, and reports
one JSON object with wall time, throughput, and the accuracy invariant.

Usage:  python -m benchmarks.harness [quickstart|covid|tb|relatedness|all]
        [--scale S]   (S multiplies dataset sizes; default 1 is CI-sized)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.counter_db import CounterDB
from kpop_tpu.core.kmers import KmerSpace
from kpop_tpu.core.space import (
    Distance,
    Metric,
    get_distance_rowwise,
    get_embeddings,
)
from kpop_tpu.core.splits import get_splits
from kpop_tpu.core.twister import TwistParameters, twist_counter_db

BASES = np.array(list("ACGT"))


def _mutate(rng, g, n):
    g = g.copy()
    pos = rng.choice(len(g), size=n, replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, size=n)) % 4
    return g


def _spectra_text(space, label, seqs):
    codes, counts = spectrum_of_sequences(space, seqs)
    from kpop_tpu.core.kmers import hex_labels_vectorized

    return "\t%s\n" % label + "".join(
        "%s\t%d\n" % (h, c)
        for h, c in zip(
            hex_labels_vectorized(codes, space.hex_width), counts
        )
    )


def _classifier_scenario(
    name, rng, k, n_classes, per_class_train, n_test, genome_len, mut_class,
    mut_seq, backend="host",
):
    space = KmerSpace("DNA-ds", k)
    root = rng.integers(0, 4, size=genome_len)
    ancestors = [_mutate(rng, root, mut_class) for _ in range(n_classes)]
    t0 = time.perf_counter()
    db = CounterDB()
    for c, anc in enumerate(ancestors):
        seqs = [
            "".join(BASES[_mutate(rng, anc, mut_seq)])
            for _ in range(per_class_train)
        ]
        db.add_spectra_bytes(
            _spectra_text(space, "C%d" % (c + 1), seqs).encode()
        )
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    twister, twisted, _ = twist_counter_db(
        db, TwistParameters(), backend="jax" if backend != "host" else "host"
    )
    t_twist = time.perf_counter() - t0
    # test set
    truth, entries = [], []
    for _ in range(n_test):
        c = int(rng.integers(0, n_classes))
        seq = "".join(BASES[_mutate(rng, ancestors[c], mut_seq)])
        codes, counts = spectrum_of_sequences(space, [seq])
        entries.append(
            list(
                zip(
                    (space.code_to_hex(int(x)) for x in codes),
                    counts.astype(float),
                )
            )
        )
        truth.append("C%d" % (c + 1))
    t0 = time.perf_counter()
    projected = twister.project_entries(entries)
    metric = twister.metrics_vector(Metric.of_string("powers(1,1,2)"))
    from kpop_tpu.core.matrix import NamedMatrix
    from kpop_tpu.core.space import summarize_rowwise

    queries = NamedMatrix(
        ["q%d" % i for i in range(n_test)],
        list(twisted.matrix.col_names),
        projected,
    )
    if backend == "host":
        lines = summarize_rowwise(
            Distance.of_string("euclidean"), metric, twisted.matrix, queries
        )
    else:
        import io as _io

        from kpop_tpu.ops.summaries import summarize_rowwise_device

        buf = _io.StringIO()
        summarize_rowwise_device(
            Distance.of_string("euclidean"), metric, twisted.matrix, queries,
            keep_at_most=2, normalize=True, out=buf,
        )
        lines = buf.getvalue().splitlines()
    t_project = time.perf_counter() - t0
    correct = sum(
        1 for ln, t in zip(lines, truth) if ln.split("\t")[5] == t
    )
    return {
        "scenario": name,
        "backend": backend,
        "k": k,
        "classes": n_classes,
        "test_sequences": n_test,
        "accuracy": correct / n_test,
        "count_s": round(t_count, 2),
        "twist_s": round(t_twist, 2),
        "project_classify_s": round(t_project, 2),
        "test_seqs_per_s": round(n_test / max(t_project, 1e-9), 1),
    }


def quickstart(scale=1, backend="host"):
    rng = np.random.default_rng(1)
    return _classifier_scenario(
        "quickstart", rng, k=5, n_classes=10, per_class_train=10 * scale,
        n_test=100 * scale, genome_len=300, mut_class=60, mut_seq=12,
        backend=backend,
    )


def covid(scale=1, backend="host"):
    """SARS-CoV-2-like: long genomes, many classes (BASELINE.md row 4)."""
    rng = np.random.default_rng(2)
    return _classifier_scenario(
        "covid-like", rng, k=10, n_classes=24 * scale, per_class_train=3,
        n_test=60 * scale, genome_len=3000 * min(scale, 10), mut_class=250,
        mut_seq=25, backend=backend,
    )


def tb(scale=1, backend="host"):
    """Reads-based classifier (BASELINE.md TB workload shape)."""
    rng = np.random.default_rng(3)
    space = KmerSpace("DNA-ds", 12)
    n_classes, genome_len = 6 * scale, 5000
    root = rng.integers(0, 4, size=genome_len)
    ancestors = [_mutate(rng, root, 400) for _ in range(n_classes)]
    read_len, coverage = 120, 3.0
    t0 = time.perf_counter()
    db = CounterDB()
    n_reads = 0
    for c, anc in enumerate(ancestors):
        genome = _mutate(rng, anc, 40)
        n = int(genome_len * coverage / read_len)
        starts = rng.integers(0, genome_len - read_len, size=n)
        reads = ["".join(BASES[genome[s : s + read_len]]) for s in starts]
        n_reads += len(reads)
        db.add_spectra_bytes(_spectra_text(space, "C%d" % c, reads).encode())
    t_count = time.perf_counter() - t0
    t0 = time.perf_counter()
    twister, twisted, _ = twist_counter_db(
        db, TwistParameters(), backend="jax" if backend != "host" else "host"
    )
    t_twist = time.perf_counter() - t0
    return {
        "scenario": "tb-reads-like",
        "backend": backend,
        "k": 12,
        "classes": n_classes,
        "reads": n_reads,
        "kmers": db.n_rows,
        "count_s": round(t_count, 2),
        "twist_s": round(t_twist, 2),
        "reads_per_s": round(n_reads / max(t_count, 1e-9), 1),
    }


def relatedness(scale=1, backend="host"):
    """All-pairs distance matrix + splits (BASELINE.md row 8)."""
    rng = np.random.default_rng(4)
    space = KmerSpace("DNA-ds", 7)
    n = 64 * scale
    root = rng.integers(0, 4, size=2000)
    db = CounterDB()
    for i in range(n):
        g = _mutate(rng, root, 100)
        db.add_spectra_bytes(
            _spectra_text(space, "S%d" % i, ["".join(BASES[g])]).encode()
        )
    twister, twisted, _ = twist_counter_db(db, TwistParameters())
    metric = twister.metrics_vector(Metric.of_string("powers(1,1,2)"))
    dist = Distance.of_string("euclidean")
    t0 = time.perf_counter()
    if backend == "host":
        dm = get_distance_rowwise(dist, metric, twisted, twisted)
    else:
        from kpop_tpu.ops.summaries import distance_rowwise_device

        dm = distance_rowwise_device(
            dist, metric, twisted.matrix, twisted.matrix
        )
    t_dist = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = get_embeddings(dist, metric, twisted)
    splits = get_splits("gaps", 1000, emb)
    t_splits = time.perf_counter() - t0
    return {
        "scenario": "relatedness",
        "backend": backend,
        "samples": n,
        "pairs": n * n,
        "distance_s": round(t_dist, 3),
        "pairs_per_s": round(n * n / max(t_dist, 1e-9)),
        "splits": len(splits.splits),
        "splits_s": round(t_splits, 3),
    }


SCENARIOS = {
    "quickstart": quickstart,
    "covid": covid,
    "tb": tb,
    "relatedness": relatedness,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", nargs="?", default="all",
                    choices=[*SCENARIOS, "all"])
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--backend", default="host",
                    choices=["host", "jax"])
    args = ap.parse_args(argv)
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        print(json.dumps(SCENARIOS[name](args.scale, backend=args.backend)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
