"""Batched Lloyd's k-means — the yakmo k-means DLL replacement.

The reference clusters each keyframe's 192-dim PsyV features into
`palette_count` groups with yakmo (k=128, 1 restart, unlimited iterations,
k-means++ init; call site /root/reference/main.pas:2127-2133, C ABI at
extern.pas:72-76). Here: distance = one [N,D]@[D,k] matmul at the contract
precision (ops.numerics), assignment = argmin, update = a one-hot matmul;
k-means++ init as a lax.fori over k with a carried min-distance vector; the
whole solver is one jitted lax.while_loop. Deterministic for a fixed seed.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .numerics import stream_precision


def _mv(x, v):
    return jnp.matmul(x, v, precision=stream_precision())


def _plus_plus_init(x, k, key):
    """k-means++ seeding: first point uniform, then D^2-weighted sampling."""
    n = x.shape[0]
    x2 = jnp.sum(x * x, axis=1)

    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    cents = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(x[first])
    d2 = x2 + jnp.sum(x[first] ** 2) - 2.0 * _mv(x, x[first])
    d2 = jnp.maximum(d2, 0.0)

    def body(i, carry):
        cents, d2, key = carry
        key, kk = jax.random.split(key)
        # sample proportional to squared distance (categorical via gumbel)
        logits = jnp.log(jnp.maximum(d2, 1e-30))
        nxt = jax.random.categorical(kk, logits)
        c = x[nxt]
        cents = cents.at[i].set(c)
        nd2 = x2 + jnp.sum(c * c) - 2.0 * _mv(x, c)
        d2 = jnp.minimum(d2, jnp.maximum(nd2, 0.0))
        return cents, d2, key

    cents, _, _ = jax.lax.fori_loop(1, k, body, (cents, d2, key))
    return cents


def _assign(x, x2, cents):
    """[N] labels + [N] squared distances via one [N,D]@[D,k] matmul."""
    c2 = jnp.sum(cents * cents, axis=1)
    dots = _mv(x, cents.T)
    d2 = x2[:, None] + c2[None, :] - 2.0 * dots
    return jnp.argmin(d2, axis=1), jnp.maximum(jnp.min(d2, axis=1), 0.0)


def _update(x, labels, k, old_cents):
    # one-hot matmul instead of segment_sum: one [k,N]@[N,D+1] dot
    # computes the per-cluster sums and counts together, with no
    # scatter-add atomics. Precision HIGHEST (IEEE float32 on every
    # backend): the default may truncate the feature operands (TF32 on a
    # GPU), drifting the centroid sums that the next assignment's argmin
    # reads.
    onehot = jax.nn.one_hot(labels, k, dtype=jnp.float32)  # [N,k]
    xa = jnp.concatenate([x, jnp.ones((x.shape[0], 1), x.dtype)], axis=1)
    sc = jnp.dot(onehot.T, xa, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    sums, counts = sc[:, :-1], sc[:, -1]
    empty = counts == 0
    cents = sums / jnp.maximum(counts, 1.0)[:, None]
    return jnp.where(empty[:, None], old_cents, cents), empty


def kmeans_core(x, k: int, max_iters: int = 100, seed: int = 0x42381337):
    """Traceable k-means body: call from inside another jitted program
    (e.g. the fused dither-prepare dispatch) or via the `kmeans` wrapper.

    Returns (labels [N] int32, centroids [k,D] f32, n_iters).

    Converges when assignments stop changing (yakmo runs to convergence;
    max_iters is a safety bound)."""
    x = x.astype(jnp.float32)
    x2 = jnp.sum(x * x, axis=1)
    key = jax.random.PRNGKey(seed)
    cents = _plus_plus_init(x, k, key)
    labels, _ = _assign(x, x2, cents)

    def cond(carry):
        _, _, changed, it = carry
        return jnp.logical_and(changed, it < max_iters)

    def body(carry):
        cents, labels, _, it = carry
        cents, _ = _update(x, labels, k, cents)
        new_labels, _ = _assign(x, x2, cents)
        changed = jnp.any(new_labels != labels)
        return cents, new_labels, changed, it + 1

    cents, labels, _, iters = jax.lax.while_loop(
        cond, body, (cents, labels, jnp.bool_(True), jnp.int32(0)))
    cents, _ = _update(x, labels, k, cents)
    return labels.astype(jnp.int32), cents, iters


kmeans = functools.partial(jax.jit,
                           static_argnames=('k', 'max_iters'))(kmeans_core)
