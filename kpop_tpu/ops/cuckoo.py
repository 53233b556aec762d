"""Cuckoo hash table for the large-k vocabulary lookup.

For k beyond the dense-LUT limit, mapping window codes to twister columns
needs an associative lookup over the observed vocabulary.  A sorted-array
binary search costs O(log V) dependent gathers per window (~21 iterations x
2 limb gathers at V=200K), and a gather-bound lookup multiplies the hot
path's cost accordingly vs the dense LUT.  A two-table cuckoo hash has a
WORST-CASE of two probes: 6 gathers per window, fully static control flow,
no data-dependent loops.

Host side builds the table once per classifier (vectorized numpy
round-based insertion with eviction); the device lookup is 6 gathers + a
handful of integer ops.  Build failure (pathological vocabulary) falls
back to the sorted-vocab binary search in :mod:`.encode`.

Replaces the hash-table machinery of the reference's
``KMers.IntHashFrequencies`` (consumed at bin/KPopCount.ml:25-60) on the
serving path, where the reference streams per-k-mer hash-table updates.
"""

from __future__ import annotations

import numpy as np

from ..config import jax_setup

jax = jax_setup()
import jax.numpy as jnp  # noqa: E402

# slots per table = next_pow2(V): total load factor <= 0.5, where two-choice
# cuckoo insertion succeeds with overwhelming probability
_MAX_ROUNDS = 200
_MAX_SEED_ATTEMPTS = 8


def _mix_np(hi: np.ndarray, lo: np.ndarray, a: int, b: int, mask: int):
    x = hi.astype(np.uint32) * np.uint32(a) ^ (
        lo.astype(np.uint32) * np.uint32(b)
    )
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    return (x & np.uint32(mask)).astype(np.int64)


def _mix_jnp(hi, lo, a: int, b: int, mask: int):
    x = hi.astype(jnp.uint32) * jnp.uint32(a) ^ (
        lo.astype(jnp.uint32) * jnp.uint32(b)
    )
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    return (x & jnp.uint32(mask)).astype(jnp.int32)


def _seeds(attempt: int) -> tuple[int, int, int, int]:
    rng = np.random.default_rng(0xC0FFEE + attempt)
    # odd multipliers give full-period multiplicative mixing
    return tuple(int(s) | 1 for s in rng.integers(1, 2**32, size=4))


def build_cuckoo(
    keys_hi: np.ndarray, keys_lo: np.ndarray
) -> tuple[np.ndarray, tuple[int, int, int, int]] | None:
    """Build a two-table cuckoo hash over distinct (hi, lo) int32 key pairs.

    Returns ``(table [6, S] int32, seeds)`` with rows
    (t1_hi, t1_lo, t1_idx, t2_hi, t2_lo, t2_idx) and empty slots marked by
    hi = -1, or ``None`` if no seed attempt converges.  The stored idx is
    the key's position in the input arrays.

    The insertion loop is vectorized round-based eviction: every unplaced
    key claims its slot in the current table (last writer wins, numpy
    scatter semantics); losers and evicted occupants move to the other
    table next round.
    """
    V = len(keys_hi)
    S = 1 << max(4, int(np.ceil(np.log2(max(V, 1) * 2))))
    mask = S - 1
    keys_hi = keys_hi.astype(np.int32)
    keys_lo = keys_lo.astype(np.int32)
    all_idx = np.arange(V, dtype=np.int32)
    for attempt in range(_MAX_SEED_ATTEMPTS):
        a1, b1, a2, b2 = _seeds(attempt)
        h1 = _mix_np(keys_hi, keys_lo, a1, b1, mask)
        h2 = _mix_np(keys_hi, keys_lo, a2, b2, mask)
        # occupant[t, s] = key index stored in slot s of table t (-1 empty)
        occ = np.full((2, S), -1, dtype=np.int64)
        pending = all_idx.copy()
        table = np.zeros(V, dtype=np.int8)  # which table each pending key tries
        for _ in range(_MAX_ROUNDS):
            if len(pending) == 0:
                break
            slot = np.where(table[pending] == 0, h1[pending], h2[pending])
            t = table[pending].astype(np.int64)
            evicted = occ[t, slot]  # may contain duplicates; snapshot first
            occ[t, slot] = pending  # last writer wins per slot
            won = occ[t, slot] == pending
            # losers stay pending; keys evicted by an actual winner move too
            evicted_real = evicted[won]
            evicted_real = evicted_real[evicted_real >= 0]
            table[evicted_real] ^= 1
            losers = pending[~won]
            # a loser may coincide with a key that was just placed by a
            # duplicate-slot race; it simply retries the other table
            table[losers] ^= 1
            pending = np.concatenate([losers, evicted_real])
        if len(pending):
            continue
        out = np.full((6, S), -1, dtype=np.int32)
        for t in range(2):
            filled = occ[t] >= 0
            kidx = occ[t][filled]
            out[3 * t + 0, filled] = keys_hi[kidx]
            out[3 * t + 1, filled] = keys_lo[kidx]
            out[3 * t + 2, filled] = kidx
        return out, (a1, b1, a2, b2)
    return None


def cuckoo_lookup(
    table: "jnp.ndarray",
    seeds: tuple[int, int, int, int],
    miss: int,
    qh: "jnp.ndarray",
    ql: "jnp.ndarray",
):
    """Device lookup: key pairs -> stored idx, or ``miss``.  Six gathers."""
    a1, b1, a2, b2 = seeds
    mask = int(table.shape[1]) - 1
    s1 = _mix_jnp(qh, ql, a1, b1, mask)
    s2 = _mix_jnp(qh, ql, a2, b2, mask)
    hit1 = (table[0, s1] == qh) & (table[1, s1] == ql)
    hit2 = (table[3, s2] == qh) & (table[4, s2] == ql)
    return jnp.where(
        hit1,
        table[2, s1],
        jnp.where(hit2, table[5, s2], jnp.int32(miss)),
    )
