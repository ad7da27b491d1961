"""JAX's persistent compilation cache, on for the GPU.

A cold encode compiles every shape bucket; the cache keeps the compiled
executables, and with them XLA's autotuning choices, from one process to
the next. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself
and nothing here overrides it. Otherwise the cache lives at one fixed
path inside the checkout (CHECKOUT_CACHE_DIR, listed in .gitignore): the
path is part of the cache key, so a directory that moved would never hit.
The CPU backend gets no cache: XLA:CPU executables are specific to the
host's CPU, and a checkout may travel to another host.
"""
from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')


def cache_dir(platform: str, environ=os.environ) -> str | None:
    """The cache directory for `platform`, or None for no cache."""
    if environ.get('JAX_COMPILATION_CACHE_DIR'):
        return environ['JAX_COMPILATION_CACHE_DIR']
    if platform != 'gpu':
        return None
    return CHECKOUT_CACHE_DIR


def enable() -> str | None:
    """Point JAX at cache_dir() for the default backend; returns it."""
    path = cache_dir(jax.default_backend())
    if path is None or 'JAX_COMPILATION_CACHE_DIR' in os.environ:
        return path
    jax.config.update('jax_compilation_cache_dir', path)
    # cache every executable, so that every autotuning choice is pinned
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    return path
