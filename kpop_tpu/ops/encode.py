"""Device-side k-mer window encoding.

JAX re-expression of the host reference :meth:`KmerSpace.window_codes`
(kpop_tpu/core/kmers.py) for batches of sequences: the hot loop of the
reference's ``KIH.iterc`` (bin/KPopCount.ml:38) becomes k shifted
vectorized adds, fused by XLA with the downstream scatter.

Sequences are pre-encoded host-side to int8 base codes (A=0 C=1 G=2 T=3,
-1 = window break / padding) and batched into ``[B, L]`` arrays.

Two code representations cover the full reference k range
(/root/reference/bin/KPopCount.ml:111-115 allows DNA k <= 30, protein
k <= 12):

- single-limb int32 codes (:func:`window_codes_batch`) for
  ``base**k < 2**31`` — feeds the dense-LUT vocabulary gather;
- two-limb (hi, lo) int32 codes (:func:`window_codes_batch_wide`) for any
  supported k — feeds a sorted-vocabulary binary search
  (:func:`kpop_tpu.ops.pipeline.vocab_lookup`), so no 4^k-sized table is
  ever materialized.
"""

from __future__ import annotations

import numpy as np

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402

DEVICE_K_MAX = 15

# Largest dense-LUT size worth keeping in HBM for the code->vocab map
# (int32 entries).  2^24 entries = 64 MB: covers the reference's flagship
# k=12 DNA configuration (4^12 = 2^24, bin/KPopCount.ml:89) exactly; any
# larger k uses two-limb codes + binary search instead.
LUT_ENTRIES_MAX = (1 << 24) + 1


def device_k_max(base: int) -> int:
    """Largest k whose codes fit int32 for the given alphabet size."""
    k = 0
    while base ** (k + 1) < 2**31:
        k += 1
    return k


def lut_k_max(base: int) -> int:
    """Largest k for which the dense code->vocab LUT path is used."""
    k = 0
    while base ** (k + 1) + 1 <= LUT_ENTRIES_MAX and k + 1 <= device_k_max(base):
        k += 1
    return k


def window_codes_batch(
    codes: "jnp.ndarray", k: int, canonical: bool, base: int = 4
):
    """``[B, L]`` int8/int32 base codes -> (window codes ``[B, L-k+1]`` int32,
    valid mask ``[B, L-k+1]`` bool).

    For canonical (DNA double-stranded) encoding the returned code is
    ``min(forward, revcomp)`` exactly as in the host reference.  ``base``
    is 4 for DNA and 20 for protein (canonical is DNA-only).
    """
    if k > device_k_max(base):
        raise ValueError(
            f"device path supports k <= {device_k_max(base)} for base "
            f"{base}, got {k}"
        )
    if canonical and base != 4:
        raise ValueError("canonical encoding is DNA-only")
    c = codes.astype(jnp.int32)
    B, L = c.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequences shorter than k: L={L}, k={k}")
    fwd = jnp.zeros((B, W), dtype=jnp.int32)
    ok = jnp.ones((B, W), dtype=jnp.bool_)
    mult = base ** (k - 1)
    for j in range(k):
        cj = jax.lax.dynamic_slice_in_dim(c, j, W, axis=1)
        fwd = fwd + jnp.maximum(cj, 0) * mult
        ok = ok & (cj >= 0)
        mult //= base
    if not canonical:
        return fwd, ok
    rc = jnp.zeros((B, W), dtype=jnp.int32)
    mult = 1
    for j in range(k):
        cj = jax.lax.dynamic_slice_in_dim(c, j, W, axis=1)
        rc = rc + jnp.maximum(3 - cj, 0) * mult
        mult *= base
    return jnp.minimum(fwd, rc), ok


def split_k(k: int, base: int) -> tuple[int, int]:
    """Split k into (k_hi, k_lo) limb widths, each fitting int32 codes."""
    k_lo = min(k, device_k_max(base))
    k_hi = k - k_lo
    if k_hi > device_k_max(base):
        raise ValueError(f"k={k} too large for two-limb base-{base} codes")
    return k_hi, k_lo


def window_codes_batch_wide(
    codes: "jnp.ndarray", k: int, canonical: bool, base: int = 4
):
    """Two-limb window codes for any reference-supported k.

    ``[B, L]`` base codes -> ``(hi, lo, ok)``, each ``[B, W]``: the full
    window code is ``hi * base**k_lo + lo`` with ``(k_hi, k_lo)`` from
    :func:`split_k` (DNA k=30 -> 30 bits + 30 bits).  Order on (hi, lo)
    pairs is lexicographic, which equals numeric order on full codes, so
    the canonical (DNA-ds) form min(forward, revcomp) is the
    lexicographically smaller pair — matching the host reference
    :meth:`KmerSpace.window_codes` exactly.
    """
    if canonical and base != 4:
        raise ValueError("canonical encoding is DNA-only")
    k_hi, k_lo = split_k(k, base)
    c = codes.astype(jnp.int32)
    B, L = c.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequences shorter than k: L={L}, k={k}")

    def slice_at(j):
        return jax.lax.dynamic_slice_in_dim(c, j, W, axis=1)

    ok = jnp.ones((B, W), dtype=jnp.bool_)
    for j in range(k):
        ok = ok & (slice_at(j) >= 0)
    zero = jnp.zeros((B, W), dtype=jnp.int32)
    # forward limbs: hi = code of bases [0, k_hi), lo = bases [k_hi, k)
    fwd_hi = zero
    mult = base ** max(k_hi - 1, 0)
    for j in range(k_hi):
        fwd_hi = fwd_hi + jnp.maximum(slice_at(j), 0) * mult
        mult //= base
    fwd_lo = zero
    mult = base ** (k_lo - 1)
    for j in range(k_hi, k):
        fwd_lo = fwd_lo + jnp.maximum(slice_at(j), 0) * mult
        mult //= base
    if not canonical:
        return fwd_hi, fwd_lo, ok
    # revcomp limbs: rc code = sum_i (3 - s[i]) * base^i, so
    # rc_hi = sum_{i in [k_lo, k)} (3 - s[i]) * base^(i - k_lo)
    # rc_lo = sum_{i in [0, k_lo)} (3 - s[i]) * base^i
    rc_hi = zero
    mult = 1
    for j in range(k_lo, k):
        rc_hi = rc_hi + jnp.maximum(3 - slice_at(j), 0) * mult
        mult *= base
    rc_lo = zero
    mult = 1
    for j in range(k_lo):
        rc_lo = rc_lo + jnp.maximum(3 - slice_at(j), 0) * mult
        mult *= base
    use_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    hi = jnp.where(use_fwd, fwd_hi, rc_hi)
    lo = jnp.where(use_fwd, fwd_lo, rc_lo)
    return hi, lo, ok


def searchsorted_2limb(vh, vl, qh, ql):
    """Vectorized lower-bound binary search over a (hi, lo)-sorted vocab.

    ``vh``/``vl``: ``[V]`` int32 limb arrays sorted by (hi, lo);
    ``qh``/``ql``: query limbs of any shape.  Returns the vocabulary index
    of each exact match, or ``V`` for misses — the same contract as the
    dense-LUT gather, with O(log V) gathers instead of a 4^k table.
    """
    V = int(vh.shape[0])
    if V == 0:
        return jnp.zeros(qh.shape, jnp.int32)
    lo = jnp.zeros(qh.shape, jnp.int32)
    hi = jnp.full(qh.shape, V, jnp.int32)
    for _ in range(max(1, V.bit_length())):
        mid = (lo + hi) >> 1
        mvh = vh[mid]
        mvl = vl[mid]
        less = (mvh < qh) | ((mvh == qh) & (mvl < ql))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    safe = jnp.minimum(lo, V - 1)
    found = (lo < V) & (vh[safe] == qh) & (vl[safe] == ql)
    return jnp.where(found, lo, V)


def spectra_from_codes(
    window_codes: "jnp.ndarray",
    valid: "jnp.ndarray",
    n_kmers: int,
    dtype=jnp.float32,
):
    """Scatter-add window codes into per-sequence dense spectra ``[B, n_kmers]``.

    Invalid windows are routed to an extra trash bucket and dropped.  This
    replaces the reference's bounded hash table (``KMers.IntHashFrequencies``)
    with the dense representation the device pipeline consumes.
    """
    B, W = window_codes.shape
    tgt = jnp.where(valid, window_codes, n_kmers)
    out = jnp.zeros((B, n_kmers + 1), dtype=dtype)
    b_idx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
    out = out.at[b_idx, tgt].add(jnp.ones((B, W), dtype=dtype))
    return out[:, :n_kmers]


def unpack_2bit_batch(packed, valid, length: int):
    """Device-side unpack of the 2-bit wire format produced by
    ``native.pack_2bit_batch``: returns [B, length] int32 base codes with
    -1 at invalid positions.  Pure shifts/masks — fuses into the window
    code computation."""
    B = packed.shape[0]
    # bases: byte i>>2, bits (i&3)*2
    idx = jnp.arange(length, dtype=jnp.int32)
    byte = packed[:, idx >> 2].astype(jnp.int32)
    base = (byte >> ((idx & 3) * 2)[None, :]) & 3
    vbyte = valid[:, idx >> 3].astype(jnp.int32)
    ok = (vbyte >> (idx & 7)[None, :]) & 1
    return jnp.where(ok == 1, base, -1)


def encode_reads_host(
    seqs: list[str], length: int | None = None, protein: bool = False
) -> np.ndarray:
    """Host helper: lint+encode sequences and pad to a common length with -1.

    Padding breaks windows at sequence ends automatically.  Uses the native
    batch encoder (one C call per batch, kpop_native.cpp kpop_encode_batch)
    when available — the protein serving path previously looped Python per
    sequence — with a numpy fallback of identical output.
    """
    try:
        from .. import native

        if native.available():
            return native.encode_batch(seqs, protein, length)
    except ImportError:
        pass
    from ..core.kmers import encode_dna, encode_protein

    enc = encode_protein if protein else encode_dna
    encoded = [enc(s) for s in seqs]
    L = length or max((len(e) for e in encoded), default=0)
    L = max(L, 1)
    out = np.full((len(encoded), L), -1, dtype=np.int8)
    for i, e in enumerate(encoded):
        out[i, : min(len(e), L)] = e[:L]
    return out
