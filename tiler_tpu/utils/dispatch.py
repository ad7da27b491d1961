"""Device-interaction counter for the encoder pipeline.

Every host<->device interaction — a jitted program launch, an eager jnp
op (which XLA compiles and launches like any other program), an H2D
upload or a D2H download — pays a per-interaction cost on top of its
work, so bench.py reports the count per step. Whether that count
explains any of the GPU's idle time is for a profiler trace to show.

This is call-site instrumentation, not a JAX hook: the C++ pjit fast
path cannot be intercepted from Python, so the pipeline notes its own
interactions where it issues them. Kinds:

  jit    — a jitted program dispatch issued by pipeline code
  eager  — an eager jnp op (gather/concat/pad outside any jit)
  h2d    — a host->device upload (jnp.asarray / device_put of host data)
  d2h    — a device->host download (np.asarray of a device array); the
           only kind that blocks the host until the device is done

The counters measure the count of interactions the pipeline issues, not
their size; use them to compare schedules, not bandwidth.
"""
from __future__ import annotations

_KINDS = ('jit', 'eager', 'h2d', 'd2h')
_counts = dict.fromkeys(_KINDS, 0)


def note(kind: str, n: int = 1) -> None:
    _counts[kind] += n


def reset() -> None:
    for k in _KINDS:
        _counts[k] = 0


def snapshot() -> dict:
    out = dict(_counts)
    out['total'] = sum(_counts.values())
    return out


def delta(before: dict) -> dict:
    """Interactions since `before` (a snapshot())."""
    now = snapshot()
    return {k: now[k] - before.get(k, 0) for k in now}
