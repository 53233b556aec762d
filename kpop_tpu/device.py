"""Device memory budgets, read from the device in one place.

Two paths size their device residency from the memory a device allows this
process: the sharded CA (``parallel/sharded.py``, stream instead of pinning
the whole table) and the automatic serving layout (``cli/classify.py``,
shard the twister rows instead of replicating them).
"""

from __future__ import annotations

import os
import sys


def memory_limit(device) -> int | None:
    """Bytes ``device`` lets this process allocate; None on the CPU, which
    is left unbudgeted.  An accelerator that reports no limit is an error:
    a guessed size would either waste the card or overrun it."""
    if device.platform == "cpu":
        return None
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {device.device_kind!r} ({device.platform}) reports no "
            "memory limit (memory_stats()['bytes_limit'])"
        )
    return int(limit)


def memory_budget(device, env_var: str, fraction: float) -> int | None:
    """Per-device budget in bytes: ``env_var`` when set (0 or negative
    disables budgeting), else ``fraction`` of :func:`memory_limit`."""
    env = os.environ.get(env_var)
    if env:
        try:
            val = int(float(env))
        except ValueError:
            # an unparseable override must not silently DISABLE budgeting
            # (the opposite of what the user asked for): warn and fall
            # through to the default
            sys.stderr.write(
                "kpop: ignoring unparseable %s=%r; using the default "
                "budget\n" % (env_var, env)
            )
        else:
            return val if val > 0 else None
    limit = memory_limit(device)
    return None if limit is None else int(limit * fraction)
