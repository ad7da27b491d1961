"""Psychovisual tile features as one batched matmul.

The reference computes a 192-dim descriptor per 8x8 tile: YUV (or LAB)
planes through either an 8x8 2-D DCT with optional JPEG-table weighting
(ComputeTilePsyVisFeatures, /root/reference/main.pas:2997-3177, DCT LUT at
main.pas:613-623) or a depth-2 Haar wavelet (WaveletGS, main.pas:2805-2840).

Both transforms are linear maps on the 64 pixels of a
plane, so each is one [64,64] matrix and the whole feature computation is a
single batched matmul  feat[n,cpn] = cpn_pixels[n,cpn] @ B * w[cpn]  that
XLA fuses with the colorspace arithmetic — replacing the reference's
unrolled 64-tap scalar loops (main.pas:3086-3166). The wavelet matrix is
derived numerically by pushing the 64 unit images through a faithful
transliteration of WaveletGS.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (DCT_BASIS_FLAT, DCT_QUANT, TILE_DCT_SIZE, TILE_W,
                         UV_RATIO)
from . import color
from .numerics import stream_precision


def _wavelet_level_np(buf: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """One Haar level on the top-left dx x dy of [n,8,8] buffers."""
    f = 1.0 / np.sqrt(2.0)
    out = buf.copy()
    t = buf[:, :dy, :dx]
    lo = (t[:, :, 0::2] + t[:, :, 1::2]) * f
    hi = (t[:, :, 0::2] - t[:, :, 1::2]) * f
    tx = np.concatenate([lo, hi], axis=2)
    lo = (tx[:, 0::2, :] + tx[:, 1::2, :]) * f
    hi = (tx[:, 0::2, :] - tx[:, 1::2, :]) * f
    out[:, :dy, :dx] = np.concatenate([lo, hi], axis=1)
    return out


@functools.cache
def wavelet_matrix() -> np.ndarray:
    """[64 pix, 64 coeff] float32 matrix of the depth-2 WaveletGS layout."""
    eye = np.eye(64).reshape(64, TILE_W, TILE_W)
    buf = eye.astype(np.float64)
    dx = dy = TILE_W
    for _ in range(3):  # depth=2 -> 8x8, 4x4, 2x2 levels
        buf = _wavelet_level_np(buf, dx, dy)
        dx //= 2
        dy //= 2
    return buf.reshape(64, 64).astype(np.float32)


@functools.cache
def feature_basis(use_wavelets: bool, q_weighting: bool):
    """Returns (B [64,64] f32, weights [3,64] f32) numpy arrays for the
    feature matmul (numpy, not device arrays: this is called from inside jit
    traces, where cached tracers would leak)."""
    if use_wavelets:
        return wavelet_matrix(), np.ones((3, 64), np.float32)
    w = UV_RATIO.reshape(1, 64) * np.ones((3, 1), np.float32)
    if q_weighting:
        w = w * DCT_QUANT.reshape(3, 64)
    return DCT_BASIS_FLAT, w.astype(np.float32)


@functools.cache
def mirror_coeff_perms(use_wavelets: bool):
    """Per-mirror coefficient transforms: for a basis B where the pixel
    flip F satisfies  B^-1 F B = S  with S an EXACT signed permutation,
    features of a mirrored tile are a static column permutation + sign of
    the unmirrored features (colorspace is pointwise, so it commutes with
    the flip). Returns (perm [4,192] int32, sign [4,192] float32) indexed
    by attrs h|v<<1, or None when the basis has no such S (the DCT LUT is
    not orthogonal; only the Haar wavelet path qualifies — verified
    numerically here, deviation must be exactly 0)."""
    basis, _w = feature_basis(use_wavelets, False)
    eye = np.eye(64).reshape(64, TILE_W, TILE_W)
    binv = np.linalg.inv(basis)
    perms = {}
    for key, flip in ((1, eye[:, :, ::-1]), (2, eye[:, ::-1, :])):
        s = binv @ flip.reshape(64, 64) @ basis
        sr = np.round(s)
        if not (np.allclose(s, sr, atol=1e-10)
                and (np.abs(sr).sum(0) == 1).all()
                and (np.abs(sr).sum(1) == 1).all()):
            return None
        # feats_flip[k] = sum_p cpn[p] (F B)[p, k] = feats[perm[k]]*sign[k]
        src, dst = np.nonzero(sr)
        perm = np.empty(64, np.int32)
        sign = np.empty(64, np.float32)
        perm[dst] = src
        sign[dst] = sr[src, dst]
        perms[key] = (perm, sign)
    ph, sh = perms[1]
    pv, sv = perms[2]
    perm4 = np.stack([np.arange(64, dtype=np.int32), ph, pv, ph[pv]])
    sign4 = np.stack([np.ones(64, np.float32), sh, sv, sh[pv] * sv])
    # plane-major 192-dim layout: same transform per plane
    off = (np.arange(3, dtype=np.int32) * 64)[None, :, None]
    return (np.tile(perm4[:, None, :], (1, 3, 1)) + off).reshape(4, 192), \
        np.tile(sign4[:, None, :], (1, 3, 1)).reshape(4, 192)


def mirror_tiles(tiles, hmir, vmir):
    """Batched H/V mirror: tiles [N,8,8,...], hmir/vmir [N] bool."""
    extra = (1,) * (tiles.ndim - 3)
    h = hmir.reshape(-1, *( (1, 1) + extra ))
    v = vmir.reshape(-1, *( (1, 1) + extra ))
    tiles = jnp.where(h, tiles[:, :, ::-1], tiles)
    return jnp.where(v, tiles[:, ::-1, :], tiles)


def rgb_tiles_to_cpn(tiles_rgb, gamma_value: float | None,
                     use_lab: bool):
    """[N,8,8,3] uint8 -> [N,3,8,8] float32 component planes."""
    unit = color.srgb_unit(tiles_rgb, gamma_value)
    cpn = color.rgb_to_lab(unit) if use_lab else color.rgb_to_yuv(unit)
    return jnp.moveaxis(cpn, -1, 1)


def pal_tiles_to_cpn(tiles_pal, palettes_rgb, gamma_value: float | None,
                     use_lab: bool):
    """Palette-rendered planes: tiles_pal [N,8,8] uint8 indices,
    palettes_rgb [N,S,3] uint8 (per-tile palette)."""
    idx = tiles_pal.astype(jnp.int32)
    rgb = jnp.take_along_axis(
        palettes_rgb, idx.reshape(idx.shape[0], -1, 1), axis=1
    ).reshape(idx.shape[0], TILE_W, TILE_W, 3)
    return rgb_tiles_to_cpn(rgb, gamma_value, use_lab)


@functools.partial(jax.jit, static_argnames=('use_wavelets', 'q_weighting'))
def psyv_from_cpn(cpn, use_wavelets: bool = False, q_weighting: bool = False):
    """[N,3,8,8] planes -> [N,192] features (plane-major coeff order)."""
    basis, weights = feature_basis(use_wavelets, q_weighting)
    n = cpn.shape[0]
    flat = cpn.reshape(n, 3, 64)
    coeff = jnp.einsum('ncp,pk->nck', flat, basis,
                       precision=stream_precision(),
                       preferred_element_type=jnp.float32)
    coeff = coeff * weights[None]
    return coeff.reshape(n, TILE_DCT_SIZE)


def pad_pow2(n: int, minimum: int = 256) -> int:
    """Round a batch size up to a power of two (bounds jit recompiles to
    log(N) shape buckets — varying batch sizes would otherwise trigger a
    fresh XLA compile per call)."""
    p = minimum
    while p < n:
        p *= 2
    return p


def _pad_batch(arr, n_pad):
    pad = n_pad - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


@functools.partial(jax.jit, static_argnames=('gamma_value', 'use_lab',
                                             'use_wavelets', 'q_weighting',
                                             'mirrored'))
def _psyv_rgb_core(t, hmir, vmir, gamma_value, use_lab, use_wavelets,
                   q_weighting, mirrored):
    if mirrored:
        t = mirror_tiles(t, hmir, vmir)
    cpn = rgb_tiles_to_cpn(t, gamma_value, use_lab)
    return psyv_from_cpn(cpn, use_wavelets=use_wavelets,
                         q_weighting=q_weighting)


@functools.partial(jax.jit, static_argnames=('gamma_value', 'use_lab',
                                             'use_wavelets', 'q_weighting',
                                             'mirrored'))
def _psyv_pal_core(t, pals, hmir, vmir, gamma_value, use_lab, use_wavelets,
                   q_weighting, mirrored):
    if mirrored:
        t = mirror_tiles(t, hmir, vmir)
    cpn = pal_tiles_to_cpn(t, pals, gamma_value, use_lab)
    return psyv_from_cpn(cpn, use_wavelets=use_wavelets,
                         q_weighting=q_weighting)


_NO_MIRROR = np.zeros(1, bool)


def psyv_features_rgb(tiles_rgb, gamma_value=None, use_lab=False,
                      use_wavelets=False, q_weighting=False,
                      hmir=None, vmir=None):
    """Full PsyV path from RGB tiles [N,8,8,3] uint8 -> [N,192] f32.

    One fused jit dispatch (colorspace + mirror + transform). Host numpy
    inputs pad to pow2 batch buckets (compile bounding); traced inputs pass
    through so the function composes inside jit/shard_map."""
    mirrored = hmir is not None
    if not isinstance(tiles_rgb, np.ndarray):
        return _psyv_rgb_core(tiles_rgb,
                              hmir if mirrored else _NO_MIRROR,
                              vmir if mirrored else _NO_MIRROR,
                              gamma_value, use_lab, use_wavelets,
                              q_weighting, mirrored)
    n = tiles_rgb.shape[0]
    n_pad = pad_pow2(n)
    t = _pad_batch(tiles_rgb, n_pad)
    hm = _pad_batch(np.asarray(hmir), n_pad) if mirrored else _NO_MIRROR
    vm = _pad_batch(np.asarray(vmir), n_pad) if mirrored else _NO_MIRROR
    return _psyv_rgb_core(t, hm, vm, gamma_value, use_lab, use_wavelets,
                          q_weighting, mirrored)[:n]


def psyv_features_pal(tiles_pal, palettes_rgb, gamma_value=None,
                      use_lab=False, use_wavelets=False, q_weighting=False,
                      hmir=None, vmir=None):
    """PsyV from palette-indexed tiles [N,8,8] + per-tile palettes [N,S,3].

    Mirrors are applied to the index plane before the palette LUT, matching
    the reference's on-the-fly mirrored reads (main.pas:3036-3047)."""
    mirrored = hmir is not None
    tiles_pal = np.asarray(tiles_pal)
    n = tiles_pal.shape[0]
    n_pad = pad_pow2(n)
    t = _pad_batch(tiles_pal, n_pad)
    pals = _pad_batch(np.asarray(palettes_rgb), n_pad)
    hm = _pad_batch(np.asarray(hmir), n_pad) if mirrored else _NO_MIRROR
    vm = _pad_batch(np.asarray(vmir), n_pad) if mirrored else _NO_MIRROR
    return _psyv_pal_core(t, pals, hm, vm, gamma_value, use_lab,
                          use_wavelets, q_weighting, mirrored)[:n]
