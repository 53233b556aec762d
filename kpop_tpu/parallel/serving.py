"""K-mer-sharded fused serving: model parallelism for ``ClassifierParams``.

The reference streams sparse projection at any vocabulary size
(/root/reference/lib/Twister.ml:58-206) and its flagship classifiers are
shapes where the twister ``[V, d]`` alone is tens of GB in f32 — e.g. the
SARS-CoV-2 lineage classifier has ~10^6 k-mers x 1,635 dims
(/root/reference/README.md:1023-1054) and the TB example uses k=12
(README.md:530), where V can reach 4^12 = 16.7M rows.  Replicating that per
device (the pure data-parallel path in cli/classify.py) fits neither one
chip's HBM nor a data-parallel mesh.

This module partitions the serving parameters over the mesh's ``"kmer"``
axis instead:

- the twister rows are sharded ``P("kmer", None)`` — the only large tensor;
- the vocab lookup tables stay replicated (dense LUT <= 64 MB by
  construction, ops/encode.py:LUT_ENTRIES_MAX; cuckoo/two-limb tables cost
  ~8-60 B per k-mer vs the twister's ``4*d`` B per k-mer, so replication is
  cheap at any reference shape — see docs/DESIGN.md for the HBM table);
- class coordinates / metric are tiny and replicated.

Each device scatter-counts only the windows whose vocab index lands in its
row range into a local ``[B, V/shard]`` slice, projects it through its
twister shard, and a single ``psum`` over ``"kmer"`` of the
``[B, d]`` partials produces the full twisted coordinates; the class
distance digest is then computed redundantly per shard (it is tiny).  The
collective payload per batch is ``B*d`` floats — independent of V — so the
design scales to arbitrary vocabulary sizes at constant collective traffic.

Semantics are identical to the replicated pipeline (ops/pipeline.py):
unknown k-mers drop, duplicates accumulate, normalization divides by the
global count of known k-mers (computable locally because the lookup tables
are replicated), matching lib/Twister.ml:146-188.
"""

from __future__ import annotations

import dataclasses

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from ..ops.pipeline import (  # noqa: E402
    ClassifierParams,
    distances_to_classes,
    vocab_lookup,
)
from .mesh import DATA_AXIS, KMER_AXIS  # noqa: E402


def shard_classifier_params(
    params: ClassifierParams, mesh: Mesh
) -> tuple[ClassifierParams, int]:
    """Lay out serving parameters on the mesh with the twister row-sharded.

    Pads the twister with zero rows so V divides the kmer-axis size (zero
    rows contribute nothing to the projection, so stray indices into the
    pad are harmless), shards it ``P("kmer", None)``, and replicates every
    other tensor.  Returns the sharded params and the *global* (unpadded)
    vocabulary size, which the serving function needs for miss indices.
    """
    V = int(params.twister.shape[0])
    n_kmer = mesh.shape[KMER_AXIS]
    pad = (-V) % n_kmer
    tw = params.twister
    if pad:
        tw = jnp.concatenate(
            [tw, jnp.zeros((pad, tw.shape[1]), tw.dtype)], axis=0
        )
    rep = NamedSharding(mesh, P())
    sharded = dataclasses.replace(
        params,
        twister=jax.device_put(tw, NamedSharding(mesh, P(KMER_AXIS, None))),
        **{
            f: jax.device_put(getattr(params, f), rep)
            for f in (
                "vocab_lut", "metric", "class_coords", "class_norms",
                "vocab_hi", "vocab_lo", "cuckoo",
            )
            if getattr(params, f) is not None
        },
    )
    return sharded, V


_SERVING_FN_CACHE: dict = {}


def _mesh_key(mesh: Mesh) -> tuple:
    return (
        tuple(mesh.axis_names),
        tuple(dict(mesh.shape).items()),
        tuple(d.id for d in mesh.devices.flat),
    )


def sharded_dmat_fn(mesh: Mesh, n_vocab: int, normalize: bool = True):
    """Jitted ``(sharded_params, base_codes) -> dmat [B, C]`` over the mesh.

    ``base_codes`` is sharded over the data axis (``P("data", None)``); the
    batch must divide the data-axis size (pad with all ``-1`` rows — they
    produce empty spectra).  Cached per (mesh, V, normalize) so repeated
    batches hit the jit cache.
    """
    key = ("dmat", _mesh_key(mesh), n_vocab, normalize)
    if key in _SERVING_FN_CACHE:
        return _SERVING_FN_CACHE[key]

    def body(p: ClassifierParams, codes):
        V_local = p.twister.shape[0]
        idx = vocab_lookup(p, codes, n_vocab=n_vocab)  # [B, W] global
        known = idx < n_vocab
        local = idx - jax.lax.axis_index(KMER_AXIS) * V_local
        in_shard = known & (local >= 0) & (local < V_local)
        tgt = jnp.where(in_shard, local, V_local)
        # the barrier keeps XLA from fusing index computation into the
        # scatter, as in ops/pipeline.count_spectra
        tgt = jax.lax.optimization_barrier(tgt)
        B, W = tgt.shape
        out = jnp.zeros((B, V_local + 1), jnp.float32)
        b_idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
        spec = out.at[b_idx, tgt].add(jnp.ones((B, W), jnp.float32))
        spec = spec[:, :V_local]
        part = jnp.dot(
            spec.astype(p.twister.dtype),
            p.twister,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        if normalize:
            # global known-kmer count: the lookup tables are replicated so
            # every shard computes the full sum locally (no collective);
            # projection is linear, so dividing the [B, d] partial saves a
            # [B, V_local] HBM pass vs normalizing the spectrum
            total = known.sum(axis=1).astype(jnp.float32)
            part = part / jnp.where(total == 0.0, 1.0, total)[:, None]
        twisted = jax.lax.psum(part, KMER_AXIS)  # [B, d] — V-independent
        return distances_to_classes(p, twisted, normalize=normalize)

    def fn(params: ClassifierParams, codes):
        # the in_specs pytree depends on the params treedef (which leaves
        # are present, plus the static meta fields), so the jitted function
        # is cached per treedef — a fresh jit(shard_map(...)) per call
        # would recompile every batch
        tdkey = (key, jax.tree.structure(params))
        jitted = _SERVING_FN_CACHE.get(tdkey)
        if jitted is None:
            # params' pytree of specs: twister row-sharded, everything
            # else replicated (matches shard_classifier_params' layout)
            specs = dataclasses.replace(
                jax.tree.map(lambda _: P(), params),
                twister=P(KMER_AXIS, None),
            )
            jitted = jax.jit(
                jax.shard_map(
                    body,
                    mesh=mesh,
                    in_specs=(specs, P(DATA_AXIS, None)),
                    out_specs=P(DATA_AXIS, None),
                )
            )
            _SERVING_FN_CACHE[tdkey] = jitted
        return jitted(params, codes)

    _SERVING_FN_CACHE[key] = fn
    return fn


def choose_kmer_parallel(
    twister_bytes: int, n_devices: int, budget_bytes: int | None
) -> int:
    """Smallest divisor of ``n_devices`` whose twister shard fits the
    per-device parameter budget (falls back to fully kmer-sharded when even
    that exceeds it — the least-bad layout).  No budget (CPU devices):
    replicate."""
    if budget_bytes is None:
        return 1
    best = n_devices
    for kp in sorted(
        d for d in range(1, n_devices + 1) if n_devices % d == 0
    ):
        if twister_bytes / kp <= budget_bytes:
            best = kp
            break
    return best
