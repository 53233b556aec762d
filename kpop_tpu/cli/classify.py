"""``kpop-classify``: one-shot FASTA/FASTQ -> distance summaries.

The production serving path: fuses what the reference runs as three
processes exchanging text (``KPopCount | KPopTwistDB -k | KPopTwistDB -s``,
reference README.md:93) into a single batched device pipeline
(:mod:`kpop_tpu.ops.pipeline`).  Output is the identical
``.KPopSummary.txt`` format; distances are computed on device in float32 and
summary statistics on host in float64 over the full per-query distance row,
preserving the reference's tie semantics.

This tool is a kpop-tpu extension (the reference has no single-process
equivalent); the multi-process pipeline above remains fully supported.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import __version__
from ..core.kmers import KmerSpace
from ..core.matrix import KPopMatrix, MatrixType
from ..core.space import Distance, Metric, summarize_distance_row
from ..core.twister import Twister
from ..io.reads import FastaInput, PairedEndFastqInput, SingleEndFastqInput, iter_reads
from ..utils.cli import Args, ParseError, Parser
from ..utils.progress import set_verbose
from ..utils.naming import SUMMARY_EXT, close_if_owned, open_out, with_ext


class AmbiguousK(ValueError):
    pass


def infer_k(
    content: str, kmer_names: list[str], k: int = 0, verbose: bool = False
) -> int:
    """Infer (or validate) k from the twister's hex k-mer labels.

    Hex width alone is not injective in k (e.g. DNA k=5 and k=6 both use 3
    hex digits), so every candidate with the right width is checked against
    the labels' maximum code; a supplied ``k`` is validated the same way and
    a mismatch is a hard error rather than silent misclassification.  When
    several k remain consistent the smallest is used with a warning — pass
    ``-k`` to silence it.
    """
    if not kmer_names:
        raise AmbiguousK("twister has no k-mer labels; pass -k")
    width = len(kmer_names[0])
    max_code = max(int(n, 16) for n in kmer_names)
    k_limit = 30 if content.startswith("DNA") else 12
    if k:
        sp = KmerSpace(content, k)
        if sp.hex_width != width or max_code >= sp.n_kmers:
            raise AmbiguousK(
                f"k={k} is inconsistent with the twister's labels "
                f"(width {width}, max code {max_code:#x}); "
                f"expected width {sp.hex_width}, codes < {sp.n_kmers:#x}"
            )
        return k
    consistent = [
        c
        for c in range(1, k_limit + 1)
        if KmerSpace(content, c).hex_width == width
        and max_code < KmerSpace(content, c).n_kmers
    ]
    if not consistent:
        raise AmbiguousK(
            f"cannot infer k from labels (width {width}, max code "
            f"{max_code:#x}); pass -k"
        )
    k = consistent[0]
    if len(consistent) > 1:
        sys.stderr.write(
            f"(KPopClassify): WARNING k is ambiguous from labels alone "
            f"(candidates {consistent}); using k={k} — pass -k to override\n"
        )
    elif verbose:
        sys.stderr.write(f"(KPopClassify): inferred k={k}\n")
    return k


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    state = {
        "twister": "",
        "targets": "",
        "inputs": [],
        "k": 0,
        "content": "DNA-ds",
        "output": "",
        "batch": 64,
        "keep_at_most": 2,
        "distance": Distance.of_string("euclidean"),
        "metric": Metric.of_string("powers(1,1,2)"),
        "normalize": True,
        "verbose": False,
        "profile": "",
        "dtype": "f32",
        "kmer_parallel": 0,
        "project_path": "auto",
    }
    p = Parser(
        "KPopClassify",
        "-T <twister_prefix> -t <twisted_prefix> -f <fasta> -o <summary_prefix>",
    )
    p.sep("Input/Output")
    p.opt(["-T", "--twister"], "<twister_binary_prefix>",
          ["twister used to project spectra ('.KPopTwister')"],
          lambda a: state.update(twister=a.get()))
    p.opt(["-t", "--targets"], "<twisted_binary_prefix>",
          ["twisted vectors to classify against ('.KPopTwisted')"],
          lambda a: state.update(targets=a.get()))
    p.opt(["-f", "--fasta"], "<fasta_file_name>",
          ["FASTA input (one spectrum per sequence)"],
          lambda a: state["inputs"].append(FastaInput(a.get())))
    p.opt(["-s", "--single-end"], "<fastq_file_name>",
          ["single-end FASTQ input"],
          lambda a: state["inputs"].append(SingleEndFastqInput(a.get())))

    def add_paired(a):
        n1, n2 = a.get(), a.get()
        state["inputs"].append(PairedEndFastqInput(n1, n2))

    p.opt(["-p", "--paired-end"], "<fastq1> <fastq2>",
          ["paired-end FASTQ input (one spectrum per pair batch)"], add_paired)
    p.opt(["-k", "--k-mer-size"], "<k_mer_length>",
          ["k-mer length (must match the twister's k-mer labels)"],
          lambda a: state.update(k=a.get_int_pos()))
    p.opt(["-C", "--content"], "'DNA-ss'|'DNA-ds'|'protein'",
          ["how file contents should be interpreted"],
          lambda a: state.update(content=a.get()), "DNA-ds")
    p.opt(["-o", "--output"], "<summary_file_prefix>",
          ["output summary prefix ('.KPopSummary.txt' unless '/dev/*')"],
          lambda a: state.update(output=a.get()))
    p.sep("Algorithm")
    p.opt(["--batch"], "<positive_integer>",
          ["sequences per device batch"],
          lambda a: state.update(batch=a.get_int_pos()), "64")
    p.opt(["--summary-keep-at-most"], "<positive_integer>",
          ["closest targets kept per query (ties extend the list)"],
          lambda a: state.update(keep_at_most=a.get_int_pos()), "2")
    p.opt(["--distance"], "'euclidean'|'cosine'|'minkowski(p)'",
          ["distance function"],
          lambda a: state.update(distance=Distance.of_string(a.get())),
          "euclidean")
    p.opt(["--metric"], "'flat'|'powers(p,thr,q)'",
          ["metric function"],
          lambda a: state.update(metric=Metric.of_string(a.get())),
          "powers(1,1,2)")

    def set_dtype(a: Args):
        v = a.get()
        if v not in ("f32", "bf16"):
            raise ParseError(f"Invalid dtype '{v}'")
        state["dtype"] = v

    def set_project_path(a: Args):
        v = a.get()
        if v not in ("auto", "dense", "bag"):
            raise ParseError(f"Invalid projection path '{v}'")
        state["project_path"] = v

    p.opt(["--dtype"], "'f32'|'bf16'",
          ["device storage dtype for the twister matrix (bf16 halves HBM",
           "footprint/traffic of the one large tensor; all accumulations",
           "stay f32; kpop-tpu extension)"],
          set_dtype, "f32")
    p.opt(["--kmer-parallel"], "<non_negative_integer>",
          ["shard the twister rows over this many devices (model",
           "parallelism over the k-mer axis; must divide the device count;",
           "0 = automatic: shard only when the replicated twister would",
           "exceed the per-device parameter budget, KPOP_PARAMS_HBM_BYTES",
           "env var, default half the device's memory limit; kpop-tpu",
           "extension)"],
          lambda a: state.update(kmer_parallel=a.get_int_non_neg()), "0")
    p.opt(["--project-path"], "'auto'|'dense'|'bag'",
          ["how reads become twisted coordinates: 'dense' scatters the",
           "[batch, vocab] spectrum then projects it with a matmul; 'bag'",
           "is the embedding-bag gather-sum (ops/pipeline.py",
           "project_reads) that never materializes spectra — suited to a",
           "large vocabulary and a small dimension count; 'auto' picks by",
           "estimated device-memory traffic; kpop-tpu extension"],
          set_project_path, "auto")
    p.opt(["--profile"], "<trace_directory>",
          ["write a JAX/XLA profiler trace of the run (view with",
           "tensorboard or xprof; kpop-tpu extension)"],
          lambda a: state.update(profile=a.get()))
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (state.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(0)))
    p.parse(argv)

    if not (state["twister"] and state["targets"] and state["inputs"]):
        raise ParseError("Options '-T', '-t' and an input are mandatory")

    twister = Twister.of_binary(state["twister"])
    targets = KPopMatrix.of_binary(MatrixType.TWISTED, state["targets"])
    k = infer_k(
        state["content"], twister.kmer_names, state["k"],
        verbose=state["verbose"],
    )
    space = KmerSpace(state["content"], k)

    # euclidean and cosine share the device matmul expansion (the reference
    # treats the distance family uniformly, lib/Space.ml:150-205); bounded
    # minkowski stays on the exact host path
    use_device = state["distance"].kind in ("euclidean", "cosine")
    if use_device:
        from ..config import jax_setup

        jax = jax_setup()
        import jax.numpy as jnp

        from ..ops.encode import encode_reads_host
        from ..ops.pipeline import (
            build_classifier_params,
            choose_project_path,
            dmat_bag,
            dmat_dense,
        )

        params = build_classifier_params(
            space,
            twister,
            np.asarray(targets.matrix.data, dtype=np.float64),
            distance=state["distance"],
            metric=state["metric"],
            dtype=jnp.bfloat16 if state["dtype"] == "bf16" else jnp.float32,
        )

        _pinned_path: list[str] = []

        def _pick_path(B: int, W: int) -> str:
            """Pinned on the first (full) batch so a differently-shaped
            tail batch cannot flip paths and pay an extra compile."""
            if state["project_path"] != "auto":
                return state["project_path"]
            if not _pinned_path:
                _pinned_path.append(choose_project_path(
                    params.n_vocab, params.twister.shape[1], B, W
                ))
                if state["verbose"]:
                    sys.stderr.write(
                        f"(KPopClassify): projection path {_pinned_path[0]}\n"
                    )
            return _pinned_path[0]

        def _dmat_replicated(p, base_codes):
            path = _pick_path(*base_codes.shape)
            fn = dmat_bag if path == "bag" else dmat_dense
            return fn(p, base_codes)

        _dmat_device = _dmat_replicated
        # multi-chip layout (reference P2/P3 scatter, SURVEY §2.5):
        # - data-parallel when the twister fits per-device HBM: shard the
        #   sequence batch, replicate the parameters;
        # - kmer-sharded (model parallel) when it does not — the flagship
        #   covid/TB vocabularies put the twister at tens of GB
        #   (README.md:1023-1054), so its rows are partitioned over the
        #   mesh's "kmer" axis and projections psum (parallel/serving.py).
        n_dev = jax.device_count()
        pad_multiple = 1
        if n_dev > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import DATA_AXIS, make_mesh
            from ..parallel.serving import (
                choose_kmer_parallel,
                shard_classifier_params,
                sharded_dmat_fn,
            )

            kmer_par = state["kmer_parallel"]
            if kmer_par:
                if n_dev % kmer_par:
                    raise ParseError(
                        f"--kmer-parallel {kmer_par} does not divide the "
                        f"device count {n_dev}"
                    )
            else:
                from ..device import memory_budget

                budget = memory_budget(
                    jax.devices()[0], "KPOP_PARAMS_HBM_BYTES", 0.5
                )
                kmer_par = choose_kmer_parallel(
                    params.twister.size * params.twister.dtype.itemsize,
                    n_dev, budget,
                )
            if kmer_par > 1:
                mesh = make_mesh(n_dev, data_parallel=n_dev // kmer_par)
                params, v_global = shard_classifier_params(params, mesh)
                _dmat_device = sharded_dmat_fn(mesh, v_global)
                if state["project_path"] == "bag":
                    sys.stderr.write(
                        "(KPopClassify): --project-path bag applies to the "
                        "replicated layout; the kmer-sharded path uses its "
                        "own per-shard scatter (parallel/serving.py)\n"
                    )
            else:
                mesh = make_mesh(data_parallel=n_dev)
                params = jax.device_put(params, NamedSharding(mesh, P()))
            if state["verbose"]:
                sys.stderr.write(
                    f"(KPopClassify): mesh {dict(mesh.shape)} "
                    f"(kmer-parallel {kmer_par})\n"
                )
            pad_multiple = mesh.shape[DATA_AXIS]
            code_sharding = NamedSharding(mesh, P(DATA_AXIS, None))

        # jit compiles per distinct [B, W] shape: bucket both axes so a
        # short tail batch / varying read lengths reuse the compiled step.
        # -1 padding encodes a window break, so padded cells count nothing.
        max_width = [0]  # widest bucket dispatched so far (never shrinks)

        def dispatch_seqs(seqs):
            """Encode and dispatch a batch; returns an ASYNC handle (the
            device computation proceeds while the host formats the
            previous batch's summary — jax dispatch is asynchronous, and
            the serve loop below keeps one batch in flight)."""
            # one native batch-encode call for either alphabet (DNA base-4 /
            # protein base-20, kpop_native.cpp kpop_encode_batch)
            codes = encode_reads_host(seqs, protein=space.base != 4)
            n = codes.shape[0]
            w = max(codes.shape[1], space.k)
            w = -(-w // 512) * 512  # width bucket
            w = max_width[0] = max(w, max_width[0])  # reuse the widest
            rows = state["batch"] if n <= state["batch"] else n
            rows += (-rows) % max(pad_multiple, 1)
            codes = np.pad(
                codes,
                ((0, rows - n), (0, w - codes.shape[1])),
                constant_values=-1,
            )
            if pad_multiple > 1:
                cd = jax.device_put(codes, code_sharding)
            else:
                cd = jnp.asarray(codes)
            return _dmat_device(params, cd), n

        def materialize(handle):
            dev, n = handle
            return np.asarray(dev, dtype=np.float64)[:n]
    else:
        # host fallback: exact float64 path (protein with large k, or
        # non-euclidean distances, which the fused device kernel doesn't
        # currently cover)
        from ..core.count import spectrum_of_sequences
        from ..core.matrix import NamedMatrix
        from ..core.space import distance_rowwise

        metric_vec = twister.metrics_vector(state["metric"])
        tmat = NamedMatrix(
            list(targets.matrix.row_names),
            list(targets.matrix.col_names),
            np.asarray(targets.matrix.data, dtype=np.float64),
        )

        def dispatch_seqs(seqs):
            entries = []
            for s in seqs:
                codes, counts = spectrum_of_sequences(space, [s])
                entries.append(
                    [
                        (space.code_to_hex(int(c)), float(v))
                        for c, v in zip(codes, counts)
                    ]
                )
            projected = twister.project_entries(entries)
            qmat = NamedMatrix(
                ["q%d" % i for i in range(len(seqs))],
                list(targets.matrix.col_names),
                projected,
            )
            return distance_rowwise(
                state["distance"], metric_vec, tmat, qmat
            ).data

        def materialize(dmat):
            return dmat

    out_path = with_ext(state["output"] or "/dev/stdout", SUMMARY_EXT)
    out = open_out(out_path)
    req_len = state["keep_at_most"]
    col_names = targets.matrix.row_names
    n_done = 0
    try:
        batch_tags: list[str] = []
        batch_seqs: list[str] = []
        pending = None  # (tags, async handle): ONE batch kept in flight

        def drain():
            """Materialize and write the in-flight batch's summaries."""
            nonlocal n_done, pending
            if pending is None:
                return
            tags, handle = pending
            pending = None
            dmat = materialize(handle)
            for tag, row in zip(tags, dmat):
                out.write(
                    summarize_distance_row(req_len, tag, row, col_names) + "\n"
                )
            n_done += len(tags)
            if state["verbose"]:
                sys.stderr.write(f"(KPopClassify): {n_done} sequences\r")

        def flush():
            nonlocal pending
            if not batch_tags:
                return
            # dispatch FIRST, then drain the previous batch: summary
            # formatting (and the next batch's parse+encode) overlap the
            # device compute + transfers of the batch just dispatched
            handle = dispatch_seqs(batch_seqs)
            tags = list(batch_tags)
            batch_tags.clear()
            batch_seqs.clear()
            drain()
            pending = (tags, handle)

        import contextlib

        if state["profile"]:
            from ..config import jax_setup

            prof = jax_setup().profiler.trace(state["profile"])
        else:
            prof = contextlib.nullcontext()
        # segment separator must break k-mer windows: any character outside
        # the alphabet ('N' for DNA; protein uses '*' since N is a residue)
        sep = "N" if state["content"].startswith("DNA") else "*"
        with prof:
            for tag, segments in iter_reads(state["inputs"]):
                batch_tags.append(tag)
                batch_seqs.append(sep.join(segments))
                if len(batch_tags) >= state["batch"]:
                    flush()
            flush()
            drain()
    finally:
        close_if_owned(out, out_path)
    if state["verbose"]:
        sys.stderr.write(f"(KPopClassify): {n_done} sequences done.\n")
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
