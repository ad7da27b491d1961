"""Exact nearest-neighbor search as streaming distance matmuls — the
ANN kd-tree (Mount/Arya) replacement.

The reference builds kd-trees with bucket size 1 and eps=0 — i.e. EXACT
search (/root/reference/main.pas:3779,3961; C ABI extern.pas:63-67) — over
64-dim PalPixels and 192-dim PsyV points. Here exact NN at these sizes is
a dense [Q,D]@[D,C] matmul with a running argmin/top-k.

Layout: candidates are padded with far points to a multiple of C_CHUNK
rows and uploaded once; a lax.scan walks [C_CHUNK, D] chunks with a
carried running argmin/top-k, so the full [Q,C] distance matrix never
exists. Distances are squared L2 (ANN's ANNdist), with the dot at the
contract precision (ops.numerics).

A fused Pallas/Triton 1-NN kernel that kept the running (err, idx) in
registers was measured against this scan on an H100 and lost, in the
kernel alone and end to end (CHANGES.md), so the scan is the only
route.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .numerics import stream_precision

C_CHUNK = 8192   # candidate rows per scan step; candidates pad to a multiple


def _pad_pow2(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _pad_rows(a, n_pad, fill=0.0):
    if a.shape[0] == n_pad:
        return a
    return np.concatenate(
        [a, np.full((n_pad - a.shape[0],) + a.shape[1:], fill, a.dtype)])


def _sq_dists(q, q2, chunk):
    """[BQ, BC] squared L2 in the expanded form, dot at contract precision."""
    c2 = jnp.sum(chunk * chunk, axis=1)
    dot = jnp.matmul(q, chunk.T, precision=stream_precision(),
                     preferred_element_type=jnp.float32)
    return q2[:, None] + c2[None, :] - 2.0 * dot


def _chunks(cands):
    return cands.reshape(-1, C_CHUNK, cands.shape[1])


def argmin_1nn(q, cands):
    """Traceable exact 1-NN: q [Q,D] f32; cands [C,D] f32 padded with far
    points to a multiple of C_CHUNK (pad_candidates) -> (idx [Q] i32,
    err [Q] f32). Ties go to the lowest candidate index."""
    q2 = jnp.sum(q * q, axis=1)

    def step(carry, chunk):
        best_err, best_idx, base = carry
        d = _sq_dists(q, q2, chunk)
        idx = jnp.argmin(d, axis=1)
        err = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
        take = err < best_err
        return (jnp.where(take, err, best_err),
                jnp.where(take, idx.astype(jnp.int32) + base, best_idx),
                base + chunk.shape[0]), None

    init = (jnp.full(q.shape[0], jnp.inf, jnp.float32),
            jnp.zeros(q.shape[0], jnp.int32), jnp.int32(0))
    (err, idx, _), _ = jax.lax.scan(step, init, _chunks(cands))
    return idx, err


_argmin_1nn_jit = jax.jit(argmin_1nn)


@functools.partial(jax.jit, static_argnames=('k',))
def _scan_topk(q, cands, k: int):
    q2 = jnp.sum(q * q, axis=1)

    def step(carry, chunk):
        best_err, best_idx, base = carry
        d = _sq_dists(q, q2, chunk)
        neg_err, idx = jax.lax.top_k(-d, k)
        merged_err = jnp.concatenate([best_err, -neg_err], axis=1)
        merged_idx = jnp.concatenate(
            [best_idx, idx.astype(jnp.int32) + base], axis=1)
        neg_best, pos = jax.lax.top_k(-merged_err, k)
        return (-neg_best, jnp.take_along_axis(merged_idx, pos, axis=1),
                base + chunk.shape[0]), None

    init = (jnp.full((q.shape[0], k), jnp.inf, jnp.float32),
            jnp.zeros((q.shape[0], k), jnp.int32), jnp.int32(0))
    (err, idx, _), _ = jax.lax.scan(step, init, _chunks(cands))
    order = jnp.argsort(err, axis=1, stable=True)
    return (jnp.take_along_axis(idx, order, axis=1),
            jnp.take_along_axis(err, order, axis=1))


def pad_candidates(candidates):
    """Pad candidates [C,D] with far points (1e9 per component, which
    never win) to a multiple of C_CHUNK rows; device-resident inputs are
    padded on device (no round trip)."""
    n_c = len(candidates)
    n_pad = max(1, -(-n_c // C_CHUNK)) * C_CHUNK - n_c
    if isinstance(candidates, jnp.ndarray):
        cp = candidates.astype(jnp.float32)
        if n_pad:
            cp = jnp.concatenate(
                [cp, jnp.full((n_pad, candidates.shape[1]), 1e9,
                              jnp.float32)])
        return cp
    return jnp.asarray(_pad_rows(np.asarray(candidates, np.float32),
                                 n_c + n_pad, fill=1e9))


def nearest_1(queries: np.ndarray, candidates: np.ndarray,
              q_chunk: int = 8192):
    """Exact 1-NN: returns (idx [Q] int32, err [Q] f32 squared L2)."""
    q_all = np.asarray(queries, np.float32)
    n_q = len(q_all)
    cands = pad_candidates(candidates)
    # queue every chunk's dispatch, download once at the end
    parts = []
    for qs in range(0, n_q, q_chunk):
        qe = min(n_q, qs + q_chunk)
        qp = _pad_pow2(qe - qs)
        q = jnp.asarray(_pad_rows(q_all[qs:qe], qp))
        _note('h2d')
        _note('jit')
        idx, err = _argmin_1nn_jit(q, cands)
        parts.append((idx[:qe - qs], err[:qe - qs]))
    return _download_parts(parts, empty_shape=(0,))


def keep_from_errs(errs: np.ndarray) -> np.ndarray:
    """Host form of the consecutive-equal-error skip mask (UseOne,
    main.pas:3832-3837): keep[:, j] = errs[:, j] != errs[:, j-1],
    keep[:, 0] = True. The device twin lives in _scan_topk_keep — the
    two must implement the same rule."""
    keep = np.ones(errs.shape, bool)
    keep[:, 1:] = errs[:, 1:] != errs[:, :-1]
    return keep


@functools.partial(jax.jit, static_argnames=('k',))
def _scan_topk_keep(q, cands, k: int):
    """_scan_topk + the consecutive-equal-error keep mask (UseOne's
    `if errs[j] = errs[j-1] then continue`, main.pas:3832-3837) computed
    ON DEVICE: the caller downloads [Q,k] i32 + [Q,k] bool instead of
    i32 + f32 — the f32 errors were half of stage-1's D2H bytes and the
    mask is all they fed."""
    idx, err = _scan_topk(q, cands, k)
    keep = jnp.concatenate(
        [jnp.ones((err.shape[0], 1), bool), err[:, 1:] != err[:, :-1]],
        axis=1)
    return idx, keep


def nearest_k_keepmask(queries, candidates, k: int,
                       q_chunk: int = 8192, n_rows: int | None = None):
    """Exact k-NN for candidate marking: (idx [Q,k] i32, keep [Q,k] bool)
    with keep[j] = err[j] != err[j-1] (keep[0] = True).

    `queries` may be a DEVICE f32 matrix (e.g. gathered on device from
    the resident tile tensor — the [Q,64] f32 upload was stage-1's
    dominant H2D bytes); pass n_rows for the valid row count then."""
    on_device = isinstance(queries, jnp.ndarray)
    q_all = queries if on_device else np.asarray(queries, np.float32)
    n_q = n_rows if n_rows is not None else len(q_all)
    cands = pad_candidates(candidates)
    parts = []
    for qs in range(0, n_q, q_chunk):
        qe = min(n_q, qs + q_chunk)
        qp = _pad_pow2(qe - qs)
        if on_device:
            _note('eager')
            q = q_all[qs:qs + qp]   # device slice (pre-padded by caller)
        else:
            _note('h2d')
            q = jnp.asarray(_pad_rows(q_all[qs:qe], qp))
        _note('jit')
        idx, keep = _scan_topk_keep(q, cands, k)
        parts.append((idx[:qe - qs], keep[:qe - qs]))
    if not parts:
        return (np.empty((0, k), np.int32), np.empty((0, k), bool))
    if len(parts) == 1:
        idx, keep = parts[0]
    else:
        _note('eager', 2)
        idx = jnp.concatenate([p[0] for p in parts])
        keep = jnp.concatenate([p[1] for p in parts])
    _note('d2h', 2)
    return np.asarray(idx), np.asarray(keep)


def nearest_k(queries: np.ndarray, candidates: np.ndarray, k: int,
              q_chunk: int = 8192):
    """Exact k-NN, ascending by distance: (idx [Q,k] i32, err [Q,k] f32).

    Matches ann_kdtree_search_multi's sorted results (extern.pas:66)."""
    q_all = np.asarray(queries, np.float32)
    n_q = len(q_all)
    cands = pad_candidates(candidates)
    parts = []
    for qs in range(0, n_q, q_chunk):
        qe = min(n_q, qs + q_chunk)
        qp = _pad_pow2(qe - qs)
        q = jnp.asarray(_pad_rows(q_all[qs:qe], qp))
        _note('h2d')
        _note('jit')
        idx, err = _scan_topk(q, cands, k)
        parts.append((idx[:qe - qs], err[:qe - qs]))
    return _download_parts(parts, empty_shape=(0, k))


def _download_parts(parts, empty_shape=(0,)):
    """[(idx, err) device slices] -> host arrays with one device concat
    + two downloads (the slicing above is lazy until this point)."""
    if not parts:
        return (np.empty(empty_shape, np.int32),
                np.empty(empty_shape, np.float32))
    if len(parts) == 1:
        idx, err = parts[0]
    else:
        idx = jnp.concatenate([p[0] for p in parts])
        err = jnp.concatenate([p[1] for p in parts])
        _note('eager', 2 + 2 * len(parts))  # slices + concats
    _note('d2h', 2)
    return np.asarray(idx), np.asarray(err)


def _note(kind, n=1):
    from ..utils.dispatch import note
    note(kind, n)
