"""Device memory size, for the budgets that bound resident batches."""
from __future__ import annotations

import jax

_DEFAULT_LIMIT = 16 << 30


def device_bytes_limit() -> int:
    """Bytes the default device lets this process allocate
    (`memory_stats()["bytes_limit"]`). Backends that report no limit (the
    CPU) count as a 16 GiB device."""
    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get('bytes_limit', _DEFAULT_LIMIT))
