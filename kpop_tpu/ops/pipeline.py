"""Fused device pipeline: reads -> spectra -> twisted coords -> classification.

This is the performance core of kpop-tpu: the reference runs this as three
processes exchanging text (KPopCount | KPopTwistDB -k | KPopTwistDB -s,
README.md:93) at ~13 seq/s/node (README.md:1049); here the whole chain is
one jitted XLA program:

    encode -> window codes -> scatter-add spectrum -> vocab gather ->
    normalize -> matmul vs twister -> metric-weighted distances ->
    tie-aware top-k

Everything is batched and static-shaped; the only host work is FASTA
parsing and int8 base encoding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402

from ..core.kmers import KmerSpace  # noqa: E402
from ..core.space import Distance, Metric  # noqa: E402
from ..core.twister import Twister  # noqa: E402
from .encode import window_codes_batch  # noqa: E402


@dataclass
class ClassifierParams:
    """Device-resident parameters of the flagship count+twist+classify model.

    Registered as a JAX pytree (k/canonical static) so instances are passed
    as *arguments* to jitted functions.  Never close over one inside a jit:
    captured device arrays become embedded HLO constants, which balloons the
    program (and its upload to remote compile services) by the full twister
    size.
    """

    vocab_lut: "jnp.ndarray | None"  # [base^k + 1] int32: code -> column (or V)
    twister: "jnp.ndarray"  # [V, d] float: twister^T (vocab-indexed)
    metric: "jnp.ndarray"  # [d]
    class_coords: "jnp.ndarray"  # [C, d]
    class_norms: "jnp.ndarray"  # [C]
    k: int
    canonical: bool
    base: int = 4  # alphabet size: 4 DNA, 20 protein
    # Large-k path (base^k too big for a dense LUT): the vocabulary as
    # two-limb codes sorted by (hi, lo); lookup is a two-table cuckoo hash
    # (worst-case two probes) or, if its build failed, a binary search over
    # the sorted limbs.  The twister rows are stored in sorted-code order.
    vocab_hi: "jnp.ndarray | None" = None  # [V] int32
    vocab_lo: "jnp.ndarray | None" = None  # [V] int32
    cuckoo: "jnp.ndarray | None" = None  # [6, S] int32 (ops/cuckoo.py)
    cuckoo_seeds: tuple = ()  # static hash seeds
    # distance family for distances_to_classes: "euclidean" or "cosine"
    # (cosine = euclidean^2 / 2 with /2-scaled norms, lib/Space.ml:150-205;
    # class_norms must be built with the same Distance)
    distance_kind: str = "euclidean"

    @property
    def n_vocab(self) -> int:
        return self.twister.shape[0]


def build_classifier_params(
    space: KmerSpace,
    twister: Twister,
    class_coords: np.ndarray,
    distance: Distance | None = None,
    metric: Metric | None = None,
    dtype=jnp.float32,
) -> ClassifierParams:
    """Assemble device parameters from host artefacts.

    For ``k <= lut_k_max`` the twister's k-mer hex labels become a dense
    lookup table over the full base^k code space (unknown k-mers route to a
    zero row, reproducing the reference's silent dropping,
    lib/Twister.ml:167-169).  For larger k — the reference allows DNA k up
    to 30 (bin/KPopCount.ml:111-115) — the vocabulary is stored as sorted
    two-limb codes and looked up by binary search; the twister rows are
    reordered to the sorted-code order.
    """
    from .encode import lut_k_max, split_k

    distance = distance or Distance.of_string("euclidean")
    metric = metric or Metric.of_string("powers(1,1,2)")
    kmer_codes = np.array(
        [space.hex_to_code(h) for h in twister.kmer_names], dtype=np.uint64
    )
    V = len(kmer_codes)
    tw = np.asarray(twister.twister.matrix.data, dtype=np.float64)  # [d, V]
    mvec = twister.metrics_vector(metric)
    from ..core.space import normalizations

    cls_norms = normalizations(distance, mvec, class_coords)
    if space.k <= lut_k_max(space.base):
        lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
        lut[kmer_codes.astype(np.int64)] = np.arange(V, dtype=np.int32)
        vocab = dict(vocab_lut=jnp.asarray(lut))
        tw_rows = tw.T
    else:
        from .cuckoo import build_cuckoo

        _k_hi, k_lo = split_k(space.k, space.base)
        limb = np.uint64(space.base**k_lo)
        order = np.argsort(kmer_codes, kind="stable")
        sorted_codes = kmer_codes[order]
        sorted_hi = (sorted_codes // limb).astype(np.int32)
        sorted_lo = (sorted_codes % limb).astype(np.int32)
        vocab = dict(vocab_lut=None)
        built = build_cuckoo(sorted_hi, sorted_lo)
        if built is not None:
            table, seeds = built
            vocab.update(cuckoo=jnp.asarray(table), cuckoo_seeds=seeds)
        else:  # pathological vocabulary: sorted-limb binary search fallback
            vocab.update(
                vocab_hi=jnp.asarray(sorted_hi),
                vocab_lo=jnp.asarray(sorted_lo),
            )
        tw_rows = tw.T[order]
    # dtype applies to the twister only (the one large tensor: bf16 halves
    # its device footprint and traffic); metric/class tensors
    # are tiny and stay f32, and all accumulations are f32
    if distance.kind not in ("euclidean", "cosine"):
        raise ValueError(
            f"device classification supports euclidean/cosine, "
            f"not {distance.kind!r}"
        )
    return ClassifierParams(
        twister=jnp.asarray(tw_rows, dtype=dtype),
        metric=jnp.asarray(mvec, dtype=jnp.float32),
        class_coords=jnp.asarray(class_coords, dtype=jnp.float32),
        class_norms=jnp.asarray(cls_norms, dtype=jnp.float32),
        k=space.k,
        canonical=space.canonical,
        base=space.base,
        distance_kind=distance.kind,
        **vocab,
    )


def vocab_lookup(
    params: ClassifierParams, base_codes: "jnp.ndarray", n_vocab: int | None = None
):
    """``[B, L]`` base codes -> (vocab index ``[B, W]`` in [0..V], with V =
    miss/invalid).  Dispatches (at trace time) between the dense-LUT gather
    (small k) and the two-limb sorted-vocabulary binary search (large k).

    ``n_vocab`` overrides the vocabulary size; it is required when the
    twister rows are sharded over a mesh axis (parallel/serving.py): inside
    ``shard_map`` ``params.twister.shape[0]`` is the *local* shard size but
    the lookup tables are replicated and produce *global* indices."""
    V = params.n_vocab if n_vocab is None else n_vocab
    if params.vocab_lut is not None:
        codes, ok = window_codes_batch(
            base_codes, params.k, params.canonical, params.base
        )
        return jnp.where(ok, params.vocab_lut[codes], V)
    from .encode import searchsorted_2limb, window_codes_batch_wide

    hi, lo, ok = window_codes_batch_wide(
        base_codes, params.k, params.canonical, params.base
    )
    if params.cuckoo is not None:
        from .cuckoo import cuckoo_lookup

        idx = cuckoo_lookup(params.cuckoo, params.cuckoo_seeds, V, hi, lo)
    else:
        idx = searchsorted_2limb(params.vocab_hi, params.vocab_lo, hi, lo)
    return jnp.where(ok, idx, V)


def count_spectra(params: ClassifierParams, base_codes: "jnp.ndarray"):
    """``[B, L]`` base codes -> vocab-aligned spectra ``[B, V]`` (+trash).

    The optimization barrier between index computation and the scatter keeps
    XLA from fusing the two (kept until measured on the GPU, ROADMAP 3.6).
    """
    V = params.n_vocab
    tgt = vocab_lookup(params, base_codes)
    B, W = tgt.shape
    tgt = jax.lax.optimization_barrier(tgt)
    # counts accumulate in f32 even when the twister is stored bf16 (a
    # bf16 count stops being exact above 256); only the matmul read
    # narrows, via astype in project()
    out = jnp.zeros((B, V + 1), dtype=jnp.float32)
    b_idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
    out = out.at[b_idx, tgt].add(jnp.ones((B, W), dtype=jnp.float32))
    return out[:, :V]


def project_reads(
    params: ClassifierParams,
    base_codes: "jnp.ndarray",
    normalize: bool = True,
    chunk: int = 2048,
):
    """Fused reads -> twisted coordinates WITHOUT materializing spectra.

    Projection is linear in the spectrum, so
    ``twisted[b] = sum_w twister[lut[code_w]] / n_known`` — an embedding-bag
    gather-sum streamed over window chunks with ``lax.scan``: it reads rows
    of 4d bytes instead of scattering into a ``[B, V]`` spectrum.

    Semantics match lib/Twister.ml:146-188: unknown k-mers drop out (zero
    twister row), duplicates accumulate, normalization divides by the total
    count of known k-mers.
    """
    V = params.n_vocab
    d = params.twister.shape[1]
    idx = vocab_lookup(params, base_codes)  # [B, W]
    B, W = idx.shape
    known = (idx < V).astype(jnp.float32)
    acc_counts = known.sum(axis=1)  # [B]
    # unknown k-mers: clamp the index and zero the contribution via the
    # known mask — appending a zero row (concatenate) would COPY the whole
    # twister, which at the flagship 16.7M x d shape is an extra 8+ GB of
    # HLO temp and an immediate OOM on one chip
    pad = (-W) % chunk
    idx_p = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=V)
    known_p = jnp.pad(known, ((0, 0), (0, pad)))
    n_chunks = idx_p.shape[1] // chunk
    idx_r = jnp.moveaxis(idx_p.reshape(B, n_chunks, chunk), 1, 0)
    known_r = jnp.moveaxis(known_p.reshape(B, n_chunks, chunk), 1, 0)

    def body(acc, xs):
        idx_chunk, known_chunk = xs
        safe = jnp.minimum(idx_chunk, V - 1)
        contrib = params.twister[safe]  # [B, chunk, d] gather, no copy
        contrib = contrib * known_chunk[..., None].astype(contrib.dtype)
        return acc + contrib.sum(axis=1, dtype=jnp.float32), None

    acc0 = jnp.zeros((B, d), jnp.float32)
    twisted, _ = jax.lax.scan(body, acc0, (idx_r, known_r))
    if normalize:
        twisted = twisted / jnp.where(acc_counts == 0.0, 1.0, acc_counts)[:, None]
    return twisted


def project(params: ClassifierParams, spectra: "jnp.ndarray", normalize=True):
    """Normalize spectra to sum 1 and project through the twister.

    Matches lib/Twister.ml:173-183 (normalization over known k-mers only —
    the trash bucket is already dropped by :func:`count_spectra`).
    Projection is linear, so the normalization divides the tiny ``[B, d]``
    output instead of the ``[B, V]`` spectrum — one full spectrum-sized
    device-memory pass saved per batch.  HIGHEST keeps an f32 twister out
    of TF32 on GPUs; a bf16 twister takes bf16 operands and f32 sums.
    """
    out = jnp.dot(
        spectra.astype(params.twister.dtype),
        params.twister,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if normalize:
        # f32 accumulation: a bf16 spectrum's counts are (near-)exact
        # per-element but a bf16 SUM over the vocab axis would round badly
        sums = spectra.sum(axis=1, dtype=jnp.float32)
        out = out / jnp.where(sums == 0.0, 1.0, sums)[:, None]
    return out


def distances_to_classes(
    params: ClassifierParams, twisted: "jnp.ndarray", normalize=True
):
    """Metric-weighted euclidean or cosine distances ``[B, C]`` via the
    matmul expansion |a-b|^2 = |a|^2 + |b|^2 - 2ab;
    cosine is the expansion / 2 with /2-scaled norms (lib/Space.ml:150-205,
    treated uniformly with euclidean like the reference)."""
    a = twisted
    cosine = params.distance_kind == "cosine"
    if normalize:
        na = (a * a * params.metric[None, :]).sum(axis=1)
        na = na / 2.0 if cosine else jnp.sqrt(na)
        na = jnp.where(na == 0.0, 1.0, na)
        a = a / na[:, None]
        b = params.class_coords / params.class_norms[:, None]
    else:
        b = params.class_coords
    am = a * params.metric[None, :]
    cross = jnp.dot(
        am, b.T, preferred_element_type=a.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    na2 = (am * a).sum(axis=1)
    nb2 = (b * b * params.metric[None, :]).sum(axis=1)
    d2 = jnp.maximum(na2[:, None] + nb2[None, :] - 2.0 * cross, 0.0)
    return d2 / 2.0 if cosine else jnp.sqrt(d2)


def summarize_batch(dmat: "jnp.ndarray", req_len: int = 2):
    """Per-query digest on device (lib/Matrix.ml:632-690 semantics):
    mean, stddev (n-1), upper median, MAD, and the indices/distances of the
    ``req_len`` nearest targets (tie expansion is applied host-side when
    formatting; here we return sorted distances + indices)."""
    B, C = dmat.shape
    mean = dmat.mean(axis=1)
    stddev = jnp.sqrt(((dmat - mean[:, None]) ** 2).sum(axis=1) / max(C - 1, 1))
    srt = jnp.sort(dmat, axis=1)
    median = srt[:, C // 2]
    mad = jnp.sort(jnp.abs(dmat - median[:, None]), axis=1)[:, C // 2]
    k = min(req_len, C)
    neg_top, idx = jax.lax.top_k(-dmat, k)
    return mean, stddev, median, mad, -neg_top, idx


@jax.jit
def dmat_dense(params: ClassifierParams, base_codes):
    """Served step, dense path: ``[B, L]`` base codes -> ``[B, C]`` class
    distances through the scattered ``[B, V]`` spectrum."""
    spectra = count_spectra(params, base_codes)
    return distances_to_classes(params, project(params, spectra))


@jax.jit
def dmat_bag(params: ClassifierParams, base_codes):
    """Served step, embedding-bag path (:func:`project_reads`)."""
    return distances_to_classes(params, project_reads(params, base_codes))


def choose_project_path(n_vocab: int, d: int, B: int, W: int) -> str:
    """'dense' or 'bag' by estimated device-memory traffic per batch.  dense
    touches the [B, V] spectrum ~3x (zero + scatter + project read) plus
    the [V, d] twister; bag gathers B*W rows of 4d bytes, weighted 16x for
    the poor efficiency of small-row gathers (a model not yet calibrated on
    the GPU, ROADMAP 1.4)."""
    bag_bytes = 4 * B * W * d * 16
    dense_bytes = 12 * B * n_vocab + 4 * n_vocab * d
    return "bag" if bag_bytes < dense_bytes else "dense"


jax.tree_util.register_dataclass(
    ClassifierParams,
    data_fields=(
        "vocab_lut",
        "twister",
        "metric",
        "class_coords",
        "class_norms",
        "vocab_hi",
        "vocab_lo",
        "cuckoo",
    ),
    meta_fields=("k", "canonical", "base", "cuckoo_seeds", "distance_kind"),
)
