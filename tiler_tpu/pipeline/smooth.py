"""Smooth step: temporal tile merge for skip-run encoding.

Reference: btnSmoothClick (/root/reference/main.pas:1338-1370) +
DoTemporalSmoothing (main.pas:4071-4119). Per cell, the PsyV DCT
(quantization-weighted, no wavelets, linear gamma) of the current
palette-rendered tile is compared with the same cell one frame earlier; if
the RMS over 192 dims is within the strength the lower-indexed tile wins
and is copied across (lower index = more used after Reindex), and the cell
is marked Smoothed for skip encoding. The reference's backward copy
(PrevTMI := TMI) overwrites the previous frame's cell INCLUDING its
Smoothed flag — that quirk is preserved.

Design: each keyframe runs as ONE fused device program — the
palette-render + PsyV feature pass and the lax.scan over the frame chain
live in the same dispatch; per-keyframe results queue on device and a
single end-of-step download returns every field. Under a device
mesh the CELL axis shards across every device (the reference's per-row
thread fan-out, main.pas:1366): cells are independent, so per-shard math
is unchanged and the stream stays byte-identical.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import TILE_DCT_SIZE
from ..ops import features
from ..utils.dispatch import note
from .state import EncoderState

_SQRT_FACTOR = 1.0 / TILE_DCT_SIZE


def _cell_features(tiles_pal_all, palettes_k, tile_idx, pal_idx, hm, vm):
    """Device-side gather + PsyV of [F*C] cells: only the reduced tileset
    (once per encode) and per-cell int32/bool index vectors go up —
    ~11x less H2D traffic than shipping gathered 64B tiles + 48B
    palettes per cell."""
    t = tiles_pal_all[tile_idx]
    pals = palettes_k[pal_idx]
    t = features.mirror_tiles(t, hm, vm)
    cpn = features.pal_tiles_to_cpn(t, pals, None, False)
    return features.psyv_from_cpn(cpn, use_wavelets=False, q_weighting=True)


def _smooth_chain(feats, tile, pal, hm, vm, strength: float):
    """The frame-chain scan. feats [F,C,192] f32, tile/pal [F,C] i32,
    hm/vm [F,C] bool. Returns stm (tile, pal, h, v, smooth) each [F,C]."""

    def step(carry, cur):
        p_tile, p_pal, p_h, p_v, p_sm, p_feat = carry
        c_feat, c_tile, c_pal, c_h, c_v = cur
        rms = jnp.sqrt(jnp.sum((c_feat - p_feat) ** 2, axis=1)
                       * _SQRT_FACTOR)
        near = jnp.abs(rms) <= strength
        fwd = near & (c_tile >= p_tile)
        bwd = near & ~fwd
        # forward: cur takes prev's fields/features
        n_tile = jnp.where(fwd, p_tile, c_tile)
        n_pal = jnp.where(fwd, p_pal, c_pal)
        n_h = jnp.where(fwd, p_h, c_h)
        n_v = jnp.where(fwd, p_v, c_v)
        n_feat = jnp.where(fwd[:, None], p_feat, c_feat)
        # backward: prev takes cur's fields, clearing its Smoothed flag
        o_tile = jnp.where(bwd, c_tile, p_tile)
        o_pal = jnp.where(bwd, c_pal, p_pal)
        o_h = jnp.where(bwd, c_h, p_h)
        o_v = jnp.where(bwd, c_v, p_v)
        o_sm = jnp.where(bwd, False, p_sm)
        out = (o_tile, o_pal, o_h, o_v, o_sm)
        return (n_tile, n_pal, n_h, n_v, near, n_feat), out

    init = (tile[0], pal[0], hm[0], vm[0],
            jnp.zeros_like(tile[0], bool), feats[0])
    xs = (feats[1:], tile[1:], pal[1:], hm[1:], vm[1:])
    carry, outs = jax.lax.scan(step, init, xs)
    # outputs are frames 0..F-2 finalized; the carry is frame F-1
    stm_tile = jnp.concatenate([outs[0], carry[0][None]], axis=0)
    stm_pal = jnp.concatenate([outs[1], carry[1][None]], axis=0)
    stm_h = jnp.concatenate([outs[2], carry[2][None]], axis=0)
    stm_v = jnp.concatenate([outs[3], carry[3][None]], axis=0)
    stm_sm = jnp.concatenate([outs[4], carry[4][None]], axis=0)
    return stm_tile, stm_pal, stm_h, stm_v, stm_sm


def _pack_stm(stm):
    """(tile, pal, h, v, sm) -> (tile i32, pal u8, flags u8): 6 bytes a
    cell to download instead of 11, three transfers instead of five."""
    tile, pal, h, v, sm = stm
    flags = (h.astype(jnp.uint8) | (v.astype(jnp.uint8) << 1)
             | (sm.astype(jnp.uint8) << 2))
    return tile, pal.astype(jnp.uint8), flags


@functools.partial(jax.jit, static_argnames=('strength',))
def _smooth_kf_fused(tiles_pal_all, palettes_k, tile, pal, hm, vm,
                     strength: float):
    """One keyframe's smoothing as ONE device program: cell features +
    the frame-chain scan fused (two dispatches and an intermediate
    [F*C,192] round trip in the unfused form)."""
    f, c = tile.shape
    feats = _cell_features(
        tiles_pal_all, palettes_k, tile.reshape(-1), pal.reshape(-1),
        hm.reshape(-1), vm.reshape(-1)).reshape(f, c, TILE_DCT_SIZE)
    return _pack_stm(_smooth_chain(feats, tile, pal, hm, vm, strength))


@functools.partial(jax.jit, static_argnames=('n_f', 'strength'))
def _smooth_kf_sliced(tiles_pal_all, pals_all, tm_tile, tm_pal, tm_h,
                      tm_v, s, kf_idx, n_f: int, strength: float):
    """_smooth_kf_fused gathering its keyframe's rows from the WHOLE-clip
    tilemap tensors on device (dynamic start, static length): the
    tilemaps and stacked palettes upload once per encode instead of five
    arrays per keyframe."""
    args = [jax.lax.dynamic_slice_in_dim(a, s, n_f)
            for a in (tm_tile, tm_pal, tm_h, tm_v)]
    return _smooth_kf_fused(tiles_pal_all, pals_all[kf_idx], *args,
                            strength=strength)


def run_smooth(state: EncoderState) -> EncoderState:
    from ..parallel.mesh_pipeline import mesh_ok, replicate, smooth_sharded
    strength = state.config.smoothing_strength
    cells = state.tilemap_size
    state.stm_tile = state.tm_tile.copy()
    state.stm_pal = state.tm_pal.copy()
    state.stm_h = state.tm_h.copy()
    state.stm_v = state.tm_v.copy()
    state.stm_smooth = np.zeros_like(state.tm_tile, bool)

    par = mesh_ok(state.mesh)
    tiles_dev = state.device_tiles_pal()  # reduced tileset, resident
    if par:
        tiles_dev = replicate(state.mesh, tiles_dev)

    # queue one fused dispatch per keyframe; download everything once.
    # Non-mesh path: the whole-clip tilemaps + stacked palettes upload
    # ONCE (5 transfers total) and each keyframe's program slices its
    # rows on device — the per-keyframe uploads were 5 round trips each.
    f_all = state.n_frames
    tm_all = None

    def upload_tm_all():
        # lazy: a clip of all-single-frame keyframes (rapid cuts) skips
        # every smoothing dispatch and must not pay the uploads either
        note('h2d', 5)
        return (jnp.asarray(state.tm_tile.reshape(f_all, cells)),
                jnp.asarray(state.tm_pal.reshape(f_all, cells)),
                jnp.asarray(state.tm_h.reshape(f_all, cells)),
                jnp.asarray(state.tm_v.reshape(f_all, cells)),
                jnp.asarray(state.palettes_rgb))
    todo = []   # (s, e, stm device tuple)
    for k, (s, e) in enumerate(state.keyframes):
        n_f = e - s + 1
        if n_f < 2:
            continue
        if not par and tm_all is None:
            tm_all = upload_tm_all()
        note('jit')
        if par:
            note('h2d', 5)
            tm = (state.tm_tile[s:e + 1].reshape(n_f, cells),
                  state.tm_pal[s:e + 1].reshape(n_f, cells),
                  state.tm_h[s:e + 1].reshape(n_f, cells),
                  state.tm_v[s:e + 1].reshape(n_f, cells))
            stm = smooth_sharded(state.mesh, tiles_dev,
                                 state.palettes_rgb[k], *tm,
                                 strength=float(strength))
        else:
            stm = _smooth_kf_sliced(
                tiles_dev, tm_all[4], *tm_all[:4],
                jnp.int32(s), jnp.int32(k), n_f=n_f,
                strength=float(strength))
        todo.append((s, e, stm))

    smoothed_cells = 0
    if todo:
        # one concat per field across keyframes, three downloads total
        if len(todo) > 1:
            note('eager', 3)
            cat = tuple(jnp.concatenate([t[2][i] for t in todo])
                        for i in range(3))
        else:
            cat = todo[0][2]
        note('d2h', 3)
        all_tile = np.asarray(cat[0])
        all_pal = np.asarray(cat[1])
        all_flags = np.asarray(cat[2])
        off = 0
        for s, e, _ in todo:
            n_f = e - s + 1
            sh = state.tm_tile[s:e + 1].shape
            tile = all_tile[off:off + n_f, :cells]
            pal = all_pal[off:off + n_f, :cells]
            flags = all_flags[off:off + n_f, :cells]
            off += n_f
            state.stm_tile[s:e + 1] = tile.reshape(sh)
            state.stm_pal[s:e + 1] = pal.astype(np.int32).reshape(sh)
            state.stm_h[s:e + 1] = ((flags & 1) != 0).reshape(sh)
            state.stm_v[s:e + 1] = ((flags & 2) != 0).reshape(sh)
            sm = ((flags & 4) != 0).reshape(sh)
            state.stm_smooth[s:e + 1] = sm
            smoothed_cells += int(sm.sum())

    state.metrics['smoothed_cells'] = smoothed_cells
    return state
