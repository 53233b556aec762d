"""Multi-host input pipeline: per-host file sharding feeding a global mesh.

The reference scales ingest by shell-level scatter (one ``KPopCount`` per
sample via ``Parallel``, README.md:571-597) and across nodes by manual file
sharding merged later with ``-a`` (README.md:1049-1067).  The equivalent
here: every JAX process reads its own slice of the input file list,
encodes batches locally (C++ fast path when available), and the per-process
batches are assembled into one global, mesh-sharded ``jax.Array`` with
``jax.make_array_from_process_local_data`` — host-to-host traffic only for the
assembly metadata, never the sequence bytes.

On a single host this degenerates gracefully (process_count == 1), which is
how the tests exercise it.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..config import jax_setup

jax = jax_setup()
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from .mesh import DATA_AXIS  # noqa: E402


def shard_files_for_process(
    files: Sequence[str],
    process_index: int | None = None,
    process_count: int | None = None,
) -> List[str]:
    """Round-robin assignment of input files to this process (P2 scatter)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [f for i, f in enumerate(files) if i % pc == pi]


def encode_fasta_batches(
    files: Sequence[str],
    batch: int,
    max_len: int,
    fastq: bool = False,
) -> Iterator[Tuple[np.ndarray, List[str]]]:
    """Stream ``(codes [b, max_len] int8, names)`` batches from files,
    using the native C++ parser when available."""
    from .. import native

    use_native = native.available()
    pending_codes: List[np.ndarray] = []
    pending_names: List[str] = []
    for path in files:
        if use_native:
            from ..utils.naming import open_in_bin

            f = open_in_bin(path)  # transparent .gz
            try:
                buf = f.read()
            finally:
                f.close()
            pos = 0
            while pos < len(buf):
                codes, names, _lens, consumed = native.fasta_encode_batch(
                    buf[pos:], batch, max_len, fastq=fastq
                )
                if len(names) == 0:
                    break
                pos += consumed
                pending_codes.append(codes)
                pending_names.extend(names)
                while len(pending_names) >= batch:
                    allc = np.concatenate(pending_codes, axis=0)
                    yield allc[:batch], pending_names[:batch]
                    pending_codes = [allc[batch:]]
                    pending_names = pending_names[batch:]
        else:
            from ..core.kmers import encode_dna
            from ..io.reads import (
                FastaInput,
                SingleEndFastqInput,
                iter_reads,
            )

            inp = SingleEndFastqInput(path) if fastq else FastaInput(path)
            for tag, segments in iter_reads([inp]):
                row = np.full(max_len, -1, dtype=np.int8)
                e = encode_dna(segments[0])[:max_len]
                row[: len(e)] = e
                pending_codes.append(row[None, :])
                pending_names.append(tag)
                if len(pending_names) >= batch:
                    yield (
                        np.concatenate(pending_codes, axis=0),
                        pending_names,
                    )
                    pending_codes, pending_names = [], []
    if pending_names:
        allc = np.concatenate(pending_codes, axis=0)
        pad = batch - len(pending_names)
        if pad > 0:
            allc = np.concatenate(
                [allc, np.full((pad, max_len), -1, dtype=np.int8)], axis=0
            )
        yield allc[:batch], pending_names


def global_batch(
    mesh: Mesh, local_codes: np.ndarray
) -> "jax.Array":
    """Assemble per-process local batches into one global jax.Array sharded
    over the "data" axis of the mesh (the global batch dimension is
    process-stacked; XLA handles placement)."""
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return jax.make_array_from_process_local_data(sharding, local_codes)
