"""Dither step: palette clustering (k-means over PsyV features), palette
quantization (DL3 or VAR), palette finalization, and tile dithering with
mirror canonicalization.

Reference: btnDitherClick (/root/reference/main.pas:858-914) driving
PrepareDitherTiles (main.pas:2097-2152), QuantizePalette (main.pas:
2154-2433), FinishQuantizePalette (main.pas:2435-2480), FinishDitherTiles
(main.pas:2482-2544) and PrepareTileMirrors (main.pas:4049-4069).

Design: per-keyframe feature extraction + k-means run as whole-array
device programs; the per-(keyframe,palette) quantizers run on host (DL3 in
C++, VAR with a heap); dithering is the batched Knoll/Yliluoma scan over
every tile at once; the lazy per-keyframe mixing-plan caches, spinlocks and
FramesLeft refcounts (main.pas:2488-2543) disappear — each phase is a bulk
pass.
"""
from __future__ import annotations

import functools

import numpy as np

from ..constants import TILE_W
from ..ops import dither, features, palette
from ..ops.kmeans import kmeans_core
from .state import EncoderState


def _dithering_gamma(cfg):
    return cfg.encoder_gamma if cfg.dithering_gamma else None


def _prepare_fused(tiles_all, idx, n: int, k: int, gamma_value, use_lab,
                   use_wavelets):
    """Device gather + PsyV + Lloyd's k-means for dither clustering, in
    ONE dispatch (module-level so the jit cache persists across
    keyframes/encodes; the k-means already specialized on the exact row
    count, so fusing the feature pass adds no compiles).

    Returns ONE packed u8 vector — [n] u8 labels followed by the [k,192]
    f32 centroids bitcast to bytes — so the caller pays a single D2H
    round trip per keyframe instead of two."""
    import jax
    feats = features.psyv_features_rgb(
        tiles_all[idx], gamma_value=gamma_value, use_lab=use_lab,
        use_wavelets=use_wavelets)
    labels, cents, _ = kmeans_core(feats[:n], k)
    # u8 labels: k <= 256 (config), a quarter of the int32 download
    import jax.numpy as jnp
    return jnp.concatenate([
        labels.astype(jnp.uint8),
        jax.lax.bitcast_convert_type(cents, jnp.uint8).reshape(-1)])


_prepare_fused_jit = None
_canon_jit = None


def prepare_dither_keyframe(state: EncoderState, k: int) -> None:
    """PsyV(LAB) features of every referenced tile + k-means clustering
    into palette_count groups (PrepareDitherTiles), fused into one device
    dispatch; only the cell index vector goes up and labels/centroids
    come down. It runs on one device even under a mesh: a sharded k-means
    compiles to another GPU program, whose last bits (and so labels)
    differ from the 1-device encode's."""
    import jax
    import jax.numpy as jnp
    from ..utils.dispatch import note
    cfg = state.config
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    n = len(cell_tiles)
    if n > 1 and cfg.palette_count > 1:
        n_pad = features.pad_pow2(n)
        idx = np.zeros(n_pad, np.int32)
        idx[:n] = cell_tiles
        note('h2d')
        note('jit')
        global _prepare_fused_jit
        if _prepare_fused_jit is None:
            _prepare_fused_jit = jax.jit(
                _prepare_fused,
                static_argnames=('n', 'k', 'gamma_value', 'use_lab',
                                 'use_wavelets'))
        # gather from THIS keyframe's tile slice of the chunked upload
        # (local indices): keyframe 0's k-means blocks only on its own
        # frames' H2D, so the host DL3 quantize it gates starts while
        # later chunks are still in flight. The dither tilemap is the
        # identity (load built it; dither is its first consumer), so
        # every referenced tile is in-range — guarded: a caller driving
        # dither on a hand-mutated state falls back to the full tensor
        # with global indices.
        base = s * state.tilemap_size
        lim = (e + 1) * state.tilemap_size
        in_range = (n == 0 or (cell_tiles.min() >= base
                               and cell_tiles.max() < lim))
        if in_range:
            tiles_src = state.device_source_tiles_range(s, e)
            idx_dev = np.maximum(idx - base, 0).astype(np.int32)
        else:
            tiles_src = state.device_source_tiles()
            idx_dev = idx
        note('d2h')
        packed = np.asarray(_prepare_fused_jit(
            tiles_src, jnp.asarray(idx_dev), n, cfg.palette_count,
            _dithering_gamma(cfg), True, cfg.use_wavelets))
        labels = packed[:n]
        state.palette_centroids[k] = np.frombuffer(
            packed[n:].tobytes(), np.float32).reshape(
                cfg.palette_count, 192)
    else:
        labels = np.zeros(n, np.int32)
    state.tile_dpi[cell_tiles] = labels


def quantize_keyframe_palettes(state: EncoderState, k: int) -> np.ndarray:
    """All palettes of keyframe k. Returns use counts [P] (by tile refs)."""
    cfg = state.config
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    active = state.tile_active[cell_tiles]
    dpi = state.tile_dpi[cell_tiles]
    use_counts = np.zeros(cfg.palette_count, np.int64)
    pattern = palette.palette_pattern(cfg.palette_count,
                                      cfg.tile_palette_size)
    pal_indexes = np.zeros((cfg.palette_count, cfg.tile_palette_size),
                           np.uint32)
    total_budget = (e - s + 1) * state.tilemap_size * TILE_W * TILE_W

    def quantize_one(p: int):
        sel = cell_tiles[active & (dpi == p)]
        use_counts[p] = len(sel)
        if cfg.use_dl3:
            # DoDennisLeeV3 packs the selected tiles' FS pixels into a
            # rectangle; the histogram only sees the pixel multiset, so we
            # feed the tile pixels directly (gathered inside the native
            # call — the [sel] fancy-index copy was a host hotspot).
            pal16 = palette.dl3_palette_tiles(
                state.tiles_rgb, sel, cfg.tile_palette_size,
                cfg.dl3_bpc, cfg.dl3_bin_cap)
            entries = palette.rgb_to_packed(pal16)
        else:
            px = state.tiles_rgb[sel].reshape(-1, 3)
            packed = palette.rgb_to_packed(px)
            cols, counts = np.unique(packed, return_counts=True)
            entries = palette.var_palette(
                cols, counts.astype(np.int64), total_budget, cfg.pal_var,
                cfg.tile_palette_size, cfg.palette_count, pattern[p])
        pal_indexes[p] = palette.sort_palette_lhs(entries)

    # the reference fans the per-(keyframe,palette) quantizers across its
    # thread pool (main.pas:901); the native DL3 call releases the GIL
    import concurrent.futures as cf
    import os
    workers = min(max(os.cpu_count() or 1, 1), 8)
    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(quantize_one, range(cfg.palette_count)))

    state.palettes_rgb[k] = palette.packed_to_rgb(pal_indexes)
    return use_counts


def finish_quantize_keyframe(state: EncoderState, k: int,
                             use_counts: np.ndarray) -> None:
    """Sort whole palettes by use count desc and remap DitheringPalIndex
    (FinishQuantizePalette). Stable tie-break by original palette index
    (the reference's unstable QuickSort order is arbitrary on ties)."""
    cfg = state.config
    order = np.lexsort((np.arange(cfg.palette_count), -use_counts))
    lut = np.empty(cfg.palette_count, np.int32)
    lut[order] = np.arange(cfg.palette_count)
    state.palettes_rgb[k] = state.palettes_rgb[k][order]
    state.palette_centroids[k] = state.palette_centroids[k][order]
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    state.tile_dpi[cell_tiles] = lut[state.tile_dpi[cell_tiles]]


def canonicalize_mirrors(tiles_pal: np.ndarray):
    """PrepareTileMirrors (main.pas:4049-4069), batched: pick the mirror
    whose source quadrant has the highest sum (first max in (vf,hf) scan
    order), bake it into the stored pixels.

    Returns (tiles_pal_baked, hmir [N] bool, vmir [N] bool)."""
    n = tiles_pal.shape[0]
    q = tiles_pal.astype(np.int64).reshape(n, 2, 4, 2, 4).sum((2, 4))
    # scan order (vf,hf) = (0,0),(0,1),(1,0),(1,1); strict > keeps first max
    sums = q.reshape(n, 4)  # [v*2+h]
    best = np.argmax(sums, axis=1)  # first max wins
    vf = (best >> 1).astype(bool)
    hf = (best & 1).astype(bool)
    out = tiles_pal.copy()
    out[hf] = out[hf][:, :, ::-1]
    out[vf] = out[vf][:, ::-1, :]
    return out, hf, vf


def _canonicalize_mirrors_dev(tiles_u8):
    """canonicalize_mirrors on device: [N,8,8] u8 -> (baked [N,8,8] u8,
    mirror bits h|v<<1 [N] u8). Zero tiles pick quadrant 0 (no flip), so
    running over the FULL tile array (inactive rows are zero) matches the
    host path's act-only treatment. Jitted at call site (eager execution
    costs one dispatch per op)."""
    import jax.numpy as jnp
    n = tiles_u8.shape[0]
    q = tiles_u8.astype(jnp.int32).reshape(n, 2, 4, 2, 4).sum((2, 4))
    best = jnp.argmax(q.reshape(n, 4), axis=1)  # first max wins
    vf = (best >> 1).astype(bool)
    hf = (best & 1).astype(bool)
    t = jnp.where(hf[:, None, None], tiles_u8[:, :, ::-1], tiles_u8)
    t = jnp.where(vf[:, None, None], t[:, ::-1, :], t)
    return t, (hf.astype(jnp.uint8) | (vf.astype(jnp.uint8) << 1))


def run_dither(state: EncoderState) -> EncoderState:
    """Software-pipelined across keyframes: keyframe k's host DL3/VAR
    quantize (GIL-releasing native code on a background thread) overlaps
    keyframe k+1's device k-means AND keyframe k-1's device dither scan —
    the reference runs these phases strictly sequentially per step
    (main.pas:858-914); overlapping them is a pure structural win.
    Identical bytes: every per-keyframe computation and
    the buf update order are unchanged, only the schedule moves.

    Phase timing semantics under the overlap: 'prepare_kmeans' is the
    device k-means loop wall, 'quantize' is only the BLOCKED wait on the
    background quantizers (0 when fully hidden), 'dither' the scan loop.
    """
    import concurrent.futures as cf
    import time
    cfg = state.config
    n_kf = len(state.keyframes)
    phases = {}

    # batched dithering of every active referenced tile with its palette;
    # per keyframe so palette-group ids fit the 8-bit dedup key field;
    # tiles gather on device from the cached tile tensor (transfer-lean:
    # u8 colors + group indices up, plans dedup'd per (palette, color))
    import jax.numpy as jnp
    from ..parallel.mesh_pipeline import mesh_ok
    if cfg.use_thomas_knoll:
        # mesh: the row-parallel Knoll halves shard across the encoder
        # mesh (identical bytes); Yliluoma stays single-device (its plan
        # table is small and the scan is a minor phase)
        dither_cached = functools.partial(
            dither.knoll_dither_tiles_cached,
            mesh=state.mesh if mesh_ok(state.mesh) else None)
    else:
        dither_cached = functools.partial(
            dither.yliluoma_dither_tiles_cached,
            mixed_colors=cfg.yliluoma_mix)
    kf_of = state.kf_of_frame()
    tile_kf = np.repeat(kf_of, state.tilemap_size)  # identity layout
    act = np.flatnonzero(state.tile_active)
    act_kf = tile_kf[act]
    # the full-clip tile tensor is built LAZILY at the first scan batch:
    # the device runs programs in enqueue order, so enqueuing its concat
    # here would park keyframe 0's prepare behind the whole-clip H2D —
    # exactly the serialization the per-keyframe upload staging removes
    tiles_dev = None
    n_total = state.n_tiles
    buf = jnp.zeros((n_total, TILE_W, TILE_W), jnp.uint8)

    # scan batching: the dedup key's 8-bit group field holds
    # 256 // palette_count keyframes per device scan, so multi-keyframe
    # clips pay the per-scan dispatch overhead (sort + compact + plan +
    # assign round trips) once per BATCH instead of once per keyframe.
    # Group ids stay distinct per keyframe, so plans and selections are
    # unchanged — identical bytes. With only a FEW keyframes the
    # tradeoff flips: per-keyframe scans (kb=1) start each scan as soon
    # as ITS quantize future resolves, overlapping the serialized host
    # DL3 tail instead of waiting for a whole batch.
    kb = max(1, 256 // cfg.palette_count)
    if n_kf <= 4:
        kb = 1
    t_quant = t_scan = 0.0
    with cf.ThreadPoolExecutor(1) as qpool:
        t0 = time.perf_counter()
        futs = []
        import os
        for k in range(n_kf):
            prepare_dither_keyframe(state, k)
            # keyframes' cell ranges are disjoint (identity tilemap), so
            # quantize(k) reading tile_dpi[cells_k] is safe against
            # prepare(k+1) writing tile_dpi[cells_{k+1}]
            futs.append(qpool.submit(quantize_keyframe_palettes, state, k))
            if os.environ.get('TILER_NO_OVERLAP') == '1':
                futs[-1].result()  # A/B switch: serialize host quantize
        phases['prepare_kmeans'] = time.perf_counter() - t0
        for b0 in range(0, n_kf, kb):
            batch = range(b0, min(b0 + kb, n_kf))
            t0 = time.perf_counter()
            for k in batch:
                finish_quantize_keyframe(state, k, futs[k].result())
            t_quant += time.perf_counter() - t0
            t0 = time.perf_counter()
            rows = np.flatnonzero((act_kf >= batch.start)
                                  & (act_kf < batch.stop))
            if rows.size:
                from ..utils.dispatch import note
                note('h2d', 2)
                note('eager', 2)  # tile gather + buf scatter
                if tiles_dev is None:
                    tiles_dev = state.device_source_tiles()
                idx = jnp.asarray(act[rows].astype(np.int32))
                sel = tiles_dev[idx]
                dpi_rows = np.maximum(state.tile_dpi[act[rows]], 0)
                groups = ((act_kf[rows] - batch.start) * cfg.palette_count
                          + dpi_rows)
                group_pals = state.palettes_rgb[batch.start:batch.stop] \
                    .reshape(-1, cfg.tile_palette_size, 3)
                dithered = dither_cached(
                    sel, group_pals,
                    jnp.asarray(groups.astype(np.int32)),
                    return_device=True)
                buf = buf.at[idx].set(dithered)
            t_scan += time.perf_counter() - t0
    phases['quantize'] = t_quant
    phases['dither'] = t_scan
    state.metrics['dither_phases'] = {k: round(v, 3)
                                      for k, v in phases.items()}

    # mirror canonicalization stays on device; only the 2-bit flags come
    # down (the [N,8,8] tiles remain device-resident through MakeUnique /
    # GlobalTiling; see state.tiles_pal property)
    import jax

    from ..utils.dispatch import note
    global _canon_jit
    if _canon_jit is None:
        _canon_jit = jax.jit(_canonicalize_mirrors_dev)
    note('jit')
    note('d2h')
    baked, mir_bits = _canon_jit(buf)
    state.set_tiles_pal_device(baked)
    mir = np.asarray(mir_bits)

    # tilemap: palette choice + effective mirrors (= baked flags, so the
    # decoder reconstructs the original orientation; see state.py docstring)
    f, th, tw = state.tm_tile.shape
    flat_tiles = state.tm_tile.reshape(-1)
    state.tm_pal = state.tile_dpi[flat_tiles].reshape(f, th, tw).copy()
    state.tm_h = ((mir & 1) != 0)[flat_tiles].reshape(f, th, tw)
    state.tm_v = ((mir & 2) != 0)[flat_tiles].reshape(f, th, tw)
    state.drop_source_tile_ranges()  # free the per-keyframe tile slices
    return state
