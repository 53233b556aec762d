"""``kpop-twistdb``: register-based action program over twisted space.

CLI-compatible with the reference's ``KPopTwistDB`` (bin/KPopTwistDB.ml):
registers twister/twisted/embeddings/distances/splits + settings, with
delayed actions for twisting spectra, computing/summarizing distances,
embeddings, splits, merges and binary/text conversion.
"""

from __future__ import annotations

import sys
from typing import List

from .. import __version__
from ..core.matrix import KPopMatrix, MatrixType
from ..core.space import (
    Distance,
    Metric,
    get_distance_rowwise,
    get_embeddings,
    set_mode as space_set_mode,
    summarize_dmatrix,
    summarize_rowwise_typed,
)
from ..core.splits import Splits, get_splits
from ..core.twister import Twister
from ..utils.cli import Args, ParseError, Parser
from ..utils.progress import set_verbose
from ..utils.naming import SUMMARY_EXT, close_if_owned, open_out, with_ext

REGISTER_TYPES = {
    "m": "metrics",
    "T": "twister",
    "t": "twisted",
    "e": "embeddings",
    "d": "distances",
    "s": "splits",
}

MATRIX_OF_REGISTER = {
    "twisted": MatrixType.TWISTED,
    "embeddings": MatrixType.VECTORS,
    "distances": MatrixType.DMATRIX,
}


def _register(a: Args, allowed: str) -> str:
    v = a.get()
    if v not in REGISTER_TYPES:
        raise ParseError(f"Invalid register type '{v}'")
    if v not in allowed:
        raise ParseError(
            f"Option '{a.current_opt}': register '{v}' not allowed here"
        )
    return REGISTER_TYPES[v]


def _parse_keep_at_most(a: Args):
    v = a.get()
    if v == "all":
        return None
    try:
        n = int(v)
        if n <= 0:
            raise ValueError
    except ValueError:
        raise ParseError(f"Invalid keep-at-most '{v}'") from None
    return n


BACKENDS = ("host", "jax")


def _backend(v: str) -> str:
    if v not in BACKENDS:
        raise ParseError(f"Invalid backend '{v}'")
    return v


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    program: List = []
    meta = {"twister_loads": 0, "verbose": False, "debug_twisting": False}

    # reference error texts, bin/KPopTwistDB.ml:368-384: the whole program
    # is validated before ANY action executes (actions are delayed), so an
    # invalid program fails without side effects
    MSG_METRIC = (
        "Options '-O m', '-e', '-d', and '-s' require a twister in the "
        "twister register to provide a metric!"
    )
    MSG_KMERS = "Option '-k' requires a twister in the twister register!"

    def act(fn, needs_twister=False, twister_msg=MSG_METRIC):
        if needs_twister and meta["twister_loads"] == 0:
            raise ParseError(twister_msg)
        program.append(fn)

    p = Parser("KPopTwistDB", "[ACTIONS]")
    p.sep("Actions.", "They are executed delayed and in order of specification.")

    def add_empty(a: Args):
        reg = _register(a, "Tted")
        if reg == "twister":
            act(lambda st: st.update(twister=Twister()))
        else:
            ty = MATRIX_OF_REGISTER[reg]
            act(lambda st: st.update({reg: KPopMatrix(ty)}))

    p.opt(["-z", "--zero", "--empty"], "'T'|'t'|'e'|'d'",
          ["load an empty database into the specified register",
           " ('T'=twister; 't'=twisted; 'e'=embeddings; 'd'=distances)"],
          add_empty)

    def add_input_binary(a: Args):
        reg = _register(a, "Tted")
        prefix = a.get()
        if reg == "twister":
            meta["twister_loads"] += 1
            act(lambda st: st.update(twister=Twister.of_binary(prefix)))
        else:
            ty = MATRIX_OF_REGISTER[reg]
            act(lambda st: st.update({reg: KPopMatrix.of_binary(ty, prefix)}))

    p.opt(["-i", "--input"], "'T'|'t'|'e'|'d' <binary_file_prefix>",
          ["load the specified binary database into the specified register",
           " (extensions: '.KPopTwister'; '.KPopTwisted'; '.KPopVectors';",
           "  '.KPopDMatrix', unless file is '/dev/*')"],
          add_input_binary)

    def add_input_tables(a: Args):
        reg = _register(a, "Tted")
        prefix = a.get()
        if reg == "twister":
            meta["twister_loads"] += 1
            act(lambda st: st.update(twister=Twister.of_files(prefix)))
        else:
            ty = MATRIX_OF_REGISTER[reg]
            act(lambda st: st.update({reg: KPopMatrix.of_table(ty, prefix)}))

    p.opt(["-I", "--Input"], "'T'|'t'|'e'|'d' <table_file_prefix>",
          ["load the specified tabular database(s) into the specified register",
           " (extensions: '.KPopTwister.txt' + '.KPopInertia.txt';",
           "  '.KPopTwisted.txt'; '.KPopVectors.txt'; '.KPopDMatrix.txt')"],
          add_input_tables)

    def add_merge_binary(a: Args):
        reg = _register(a, "ted")
        prefix = a.get()
        ty = MATRIX_OF_REGISTER[reg]
        act(lambda st: st.update(
            {reg: st[reg].merge_rowwise(KPopMatrix.of_binary(ty, prefix))}
        ))

    p.opt(["-a", "--add"], "'t'|'e'|'d' <binary_file_prefix>",
          ["add the contents of the specified binary database to the register"],
          add_merge_binary)

    def add_merge_tables(a: Args):
        reg = _register(a, "ted")
        prefix = a.get()
        ty = MATRIX_OF_REGISTER[reg]
        act(lambda st: st.update(
            {reg: st[reg].merge_rowwise(KPopMatrix.of_table(ty, prefix))}
        ))

    p.opt(["-A", "--Add"], "'t'|'e'|'d' <table_file_prefix>",
          ["add the contents of the specified tabular database to the register"],
          add_merge_tables)

    p.opt(["--counts-normalize", "--counts-normalization"], "'true'|'false'",
          ["whether to normalize spectra before twisting"],
          lambda a: (lambda b: act(lambda st: st.update(kmers_normalize=b)))(
              a.get_bool()),
          "true")

    p.opt(
        ["-k", "--kmers", "--add-kmers", "--add-kmer-files"],
        "<k-mer_table_file_name>[,...]",
        ["twist k-mers from the specified files through the twister register",
         "and add the results to the twisted register"],
        lambda a: (lambda fnames: act(
            lambda st: st.update(
                twisted=st["twister"].add_twisted_from_files(
                    st["twisted"],
                    fnames,
                    normalize=st["kmers_normalize"],
                    debug=meta["debug_twisting"],
                )
            ),
            needs_twister=True,
            twister_msg=MSG_KMERS,
        ))(a.get().split(",")),
    )
    # hidden: profile the three phases of spectrum projection
    p.opt(["--debug-twisting"], None, [],
          lambda a: meta.update(debug_twisting=True))
    p.opt(["--distance", "--distance-function"],
          "'euclidean'|'cosine'|'minkowski(<non_negative_float>)'",
          ["function used when computing distances"],
          lambda a: (lambda d: act(lambda st: st.update(distance=d)))(
              Distance.of_string(a.get())),
          "euclidean")
    def add_distance_mode(a: Args):
        v = a.get()
        if v not in ("fail", "infinity"):
            raise ParseError(f"Invalid distance mode '{v}'")
        act(lambda st: space_set_mode(v))

    p.opt(["--distance-mode"], "'fail'|'infinity'",
          ["behaviour on incompatible geometries when computing distances:",
           "raise an error ('fail') or yield +infinity distances ('infinity')",
           " (lib/Space.ml:46-51 semantics)"],
          add_distance_mode,
          "fail")
    p.opt(["--distance-normalize", "--distance-normalization"], "'true'|'false'",
          ["whether to normalize twisted vectors before computing distances"],
          lambda a: (lambda b: act(lambda st: st.update(distance_normalize=b)))(
              a.get_bool()),
          "true")
    p.opt(["-m", "--metric", "--metric-function"],
          "'flat'|'powers(<p_int>,<threshold>,<p_ext>)'",
          ["metric function used when computing distances"],
          lambda a: (lambda m: act(lambda st: st.update(metric=m)))(
              Metric.of_string(a.get())),
          "powers(1,1,2)")
    p.opt(
        ["-e", "--embeddings", "--compute-embeddings", "--twisted-to-embeddings"],
        None,
        ["compute embeddings from the twisted register using the metric",
         "induced by the twister register; result -> embeddings register"],
        lambda a: act(
            lambda st: st.update(
                embeddings=get_embeddings(
                    st["distance"],
                    st["twister"].metrics_vector(st["metric"]),
                    st["twisted"],
                    normalize=st["distance_normalize"],
                )
            ),
            needs_twister=True,
        ),
    )
    p.opt(["--splits-algorithm"], "'gaps'|'centroids'",
          ["algorithm used when computing splits from embeddings"],
          lambda a: (lambda v: act(lambda st: st.update(splits_algorithm=v)))(
              a.get()),
          "gaps")
    p.opt(["--splits-at-most", "--splits-keep-at-most"], "<positive_integer>|'all'",
          ["maximum number of phylogenetic splits to keep"],
          lambda a: (lambda v: act(lambda st: st.update(splits_keep_at_most=v)))(
              a.get_int_pos()),
          "10000")
    p.opt(["--splits-seed", "--seed"], "<integer>",
          ["RNG seed for the centroids splits annealing",
           "(kpop-tpu extension for reproducibility)"],
          lambda a: (lambda v: act(lambda st: st.update(splits_seed=v)))(
              a.get_int()))
    p.opt(
        ["-p", "--splits", "--compute-splits", "--embeddings-to-splits"],
        None,
        ["compute phylogenetic splits from the embeddings register;",
         "result -> splits register"],
        lambda a: act(lambda st: st.update(
            splits=get_splits(
                st["splits_algorithm"], st["splits_keep_at_most"],
                st["embeddings"], seed=st["splits_seed"],
            )
        )),
    )
    def _compute_distances(st, prefix):
        queries = KPopMatrix.of_binary(MatrixType.TWISTED, prefix)
        if st["backend"] != "host":
            from ..ops.summaries import distance_rowwise_device

            st["twisted"].expect(MatrixType.TWISTED)
            queries.expect(MatrixType.TWISTED)
            st["distances"] = KPopMatrix(
                MatrixType.DMATRIX,
                distance_rowwise_device(
                    st["distance"],
                    st["twister"].metrics_vector(st["metric"]),
                    st["twisted"].matrix,
                    queries.matrix,
                    normalize=st["distance_normalize"],
                ),
            )
        else:
            st["distances"] = get_distance_rowwise(
                st["distance"],
                st["twister"].metrics_vector(st["metric"]),
                st["twisted"],
                queries,
                normalize=st["distance_normalize"],
            )

    p.opt(
        ["-d", "--distances", "--compute-distances", "--compute-twisted-distances"],
        "<twisted_binary_file_prefix>",
        ["compute distances between the twisted register and the specified",
         "twisted binary file; result -> distance register"],
        lambda a: (lambda prefix: act(
            lambda st: _compute_distances(st, prefix),
            needs_twister=True,
        ))(a.get()),
    )

    def add_output_binary(a: Args):
        reg = _register(a, "Tteds")
        prefix = a.get()
        if reg == "twister":
            act(lambda st: st["twister"].to_binary(prefix))
        elif reg == "splits":
            act(lambda st: st["splits"].to_binary(prefix))
        else:
            act(lambda st: st[reg].to_binary(prefix))

    p.opt(["-o", "--output"], "'T'|'t'|'e'|'d'|'s' <binary_file_prefix>",
          ["save the specified register to a binary file",
           " (extensions: '.KPopTwister'; '.KPopTwisted'; '.KPopVectors';",
           "  '.KPopDMatrix'; '.PhyloSplits')"],
          add_output_binary)
    p.opt(["--precision-for-tables"], "<positive_integer>",
          ["precision digits used when outputting tables"],
          lambda a: (lambda v: act(lambda st: st.update(precision_tables=v)))(
              a.get_int_pos()),
          "15")
    p.opt(["--precision-for-splits"], "<positive_integer>",
          ["precision digits used when outputting splits"],
          lambda a: (lambda v: act(lambda st: st.update(precision_splits=v)))(
              a.get_int_pos()),
          "10")

    def add_output_tables(a: Args):
        reg_code = a.get()
        if reg_code not in REGISTER_TYPES:
            raise ParseError(f"Invalid register type '{reg_code}'")
        reg = REGISTER_TYPES[reg_code]
        prefix = a.get()
        if reg == "twister":
            act(lambda st: st["twister"].to_files(
                prefix, precision=st["precision_tables"]))
        elif reg == "metrics":
            act(
                lambda st: st["twister"]
                .metrics_matrix(st["metric"])
                .to_table(prefix, precision=st["precision_tables"]),
                needs_twister=True,
            )
        elif reg == "splits":
            act(lambda st: st["splits"].to_file(
                prefix, precision=st["precision_splits"]))
        else:
            act(lambda st: st[reg].to_table(
                prefix, precision=st["precision_tables"]))

    p.opt(["-O", "--Output"], "'T'|'t'|'e'|'d'|'m'|'s' <table_file_prefix>",
          ["save the specified register to tabular file(s)",
           " (extensions: '.KPopTwister.txt' + '.KPopInertia.txt';",
           "  '.KPopTwisted.txt'; '.KPopVectors.txt'; '.KPopDMatrix.txt';",
           "  '.KPopMetrics.txt'; '.PhyloSplits.txt')"],
          add_output_tables)
    p.opt(["--summary-at-most", "--summary-keep-at-most"],
          "<positive_integer>|'all'",
          ["maximum number of closest target sequences kept when summarizing",
           "distances (more may be printed in case of ties)"],
          lambda a: (lambda v: act(lambda st: st.update(summary_keep_at_most=v)))(
              _parse_keep_at_most(a)),
          "2")

    p.opt(["--backend"], "'host'|'jax'",
          ["compute backend for -d distances and -s summaries: float64 host",
           "numpy (exact, default) or batched device kernels ('jax') —",
           "a kpop-tpu extension for large workloads; float32 distances,",
           "same tie semantics"],
          lambda a: (lambda v: act(lambda st: st.update(backend=v)))(
              _backend(a.get())),
          "host")

    def add_summary_from_twisted(a: Args):
        prefix_in = a.get()
        prefix_out = a.get()

        def run(st):
            queries = KPopMatrix.of_binary(MatrixType.TWISTED, prefix_in)
            path = with_ext(prefix_out, SUMMARY_EXT)
            f = open_out(path)
            try:
                if st["backend"] != "host":
                    from ..ops.summaries import summarize_rowwise_device

                    queries.expect(MatrixType.TWISTED)
                    st["twisted"].expect(MatrixType.TWISTED)
                    summarize_rowwise_device(
                        st["distance"],
                        st["twister"].metrics_vector(st["metric"]),
                        st["twisted"].matrix,
                        queries.matrix,
                        keep_at_most=st["summary_keep_at_most"],
                        normalize=st["distance_normalize"],
                        out=f,
                    )
                else:
                    for ln in summarize_rowwise_typed(
                        st["distance"],
                        st["twister"].metrics_vector(st["metric"]),
                        st["twisted"],
                        queries,
                        keep_at_most=st["summary_keep_at_most"],
                        normalize=st["distance_normalize"],
                    ):
                        f.write(ln + "\n")
            finally:
                close_if_owned(f, path)

        act(run, needs_twister=True)

    p.opt(
        ["-s", "--compute-and-summarize-distances",
         "--compute-and-summarize-twisted-distances"],
        "<twisted_binary_file_prefix> <summary_file_prefix>",
        ["compute distances between the twisted register and the specified",
         "twisted binary file, summarize them, and write the result",
         " (extension '.KPopSummary.txt' unless file is '/dev/*')"],
        add_summary_from_twisted,
    )

    def add_summary_from_distances(a: Args):
        prefix = a.get()

        def run(st):
            lines = summarize_dmatrix(st["distances"], st["summary_keep_at_most"])
            path = with_ext(prefix, SUMMARY_EXT)
            f = open_out(path)
            try:
                for ln in lines:
                    f.write(ln + "\n")
            finally:
                close_if_owned(f, path)

        act(run)

    p.opt(["-S", "--summarize-distances", "--summarize-twisted-distances"],
          "<summary_file_prefix>",
          ["summarize the distances present in the distance register",
           " (extension '.KPopSummary.txt' unless file is '/dev/*')"],
          add_summary_from_distances)
    p.sep("Miscellaneous options.", "They are set immediately.")
    p.opt(["-T", "--threads"], "<computing_threads>",
          ["advisory; XLA/BLAS decide"], lambda a: a.get_int_pos())
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (meta.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(0)))
    p.parse(argv)

    if not program:
        p.usage()
        return 0

    st = dict(
        twister=Twister(),
        twisted=KPopMatrix(MatrixType.TWISTED),
        embeddings=KPopMatrix(MatrixType.VECTORS),
        distances=KPopMatrix(MatrixType.DMATRIX),
        splits=Splits([]),
        metric=Metric.of_string("powers(1,1,2)"),
        kmers_normalize=True,
        distance=Distance.of_string("euclidean"),
        distance_normalize=True,
        splits_algorithm="gaps",
        splits_keep_at_most=10000,
        splits_seed=None,
        summary_keep_at_most=2,
        backend="host",
        precision_tables=15,
        precision_splits=10,
    )
    for fn in program:
        fn(st)
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
