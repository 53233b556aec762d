"""Device mesh construction and sharding helpers.

The reference's parallelism is fork-based multiprocessing within one node
plus manual multi-node sharding with file merges (SURVEY.md §2.5).  The
replacement here is a single ``jax.sharding.Mesh`` with two logical
axes:

- ``"data"``  — samples / query batches (the reference's P2/P3 scatter),
- ``"kmer"``  — the 4^k spectrum axis (the reference's "long sequence"
  analogue; sharded model-parallel style for counting, CA and projection).

Shardings are expressed with ``NamedSharding`` + ``jit`` so XLA inserts the
collectives (psum over "kmer" for Gram matrices and projections; all-gathers
over "data" for cross-batch reductions) and they ride the device interconnect, not host memory.
"""

from __future__ import annotations

from ..config import jax_setup

jax = jax_setup()

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

DATA_AXIS = "data"
KMER_AXIS = "kmer"


def make_mesh(
    n_devices: int | None = None, data_parallel: int | None = None
) -> Mesh:
    """Create a 2D (data, kmer) mesh over the first ``n_devices`` devices.

    ``data_parallel`` fixes the size of the data axis; by default devices are
    split as evenly as possible with the kmer axis at least as large.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if data_parallel is None:
        dp = 1
        while dp * dp * 2 <= n and n % (dp * 2) == 0:
            dp *= 2
    else:
        dp = data_parallel
    if n % dp != 0:
        raise ValueError(f"{n} devices not divisible by data_parallel={dp}")
    import numpy as np

    arr = np.array(devices).reshape(dp, n // dp)
    return Mesh(arr, (DATA_AXIS, KMER_AXIS))


def spec(*axes) -> P:
    return P(*axes)


def shard(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def device_canonical(x):
    """Pre-cast a host array to the dtype JAX would canonicalize it to.

    ``jax.device_put`` onto a cross-process sharding asserts the value is
    identical on every process by broadcasting it through the devices; a
    float64 input truncates to float32 in that round-trip (x64 disabled) and
    the assert then fails against the local float64 copy.  Casting up front
    makes the comparison exact and costs nothing — the cast would happen on
    transfer anyway.
    """
    import numpy as np

    x = np.asarray(x)
    if not jax.config.read("jax_enable_x64"):
        for src, dst in (
            (np.float64, np.float32),
            (np.int64, np.int32),
            (np.uint64, np.uint32),
            (np.complex128, np.complex64),
        ):
            if x.dtype == src:
                return x.astype(dst)
    return x


def pad_to_multiple(x, axis: int, multiple: int, fill=0):
    """Pad an array so dim ``axis`` is divisible by ``multiple`` (sharding
    requires evenly divisible global shapes)."""
    import numpy as np

    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return np.pad(x, pads, constant_values=fill), size
