"""GlobalTiling step: reduce the global tileset to a budget with KModes.

Reference: DoGlobalTiling (/root/reference/main.pas:4256-4370):
per-tile 80-byte signatures (64 palette indices + 16 zone-occupancy flags,
WriteTileDatasetLine main.pas:4167-4183, GetTilePalZoneThres
main.pas:4142-4165); tiles binned by DitheringPalIndex; the tile budget is
shared across bins proportional to EqualQualityTileCount(bin size)
(main.pas:4319-4328); KModes per bin; each cluster is replaced by the
member closest to its centroid and the rest merge into it
(DoKModes main.pas:4195-4254); finally global MakeUnique + Reindex and a
GTS tileset dump. GTS reload (ReloadPreviousTiling, main.pas:4372-4470)
replaces each tile with its nearest line from a previous tileset.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.gtm import read_gts, write_gts
from ..constants import (KMODES_ZONE_COUNT, TILE_W,
                         equal_quality_tile_count)
from ..ops.kmodes import min_dissim_index_last
from .reindex import run_reindex
from .state import EncoderState
from .unique import run_make_unique


def tile_signatures(tiles_pal: np.ndarray, tile_palette_size: int
                    ) -> np.ndarray:
    """[N,8,8] uint8 -> [N,80] uint8 KModes feature lines."""
    n = tiles_pal.shape[0]
    flat = tiles_pal.reshape(n, 64).astype(np.int64)
    zone_of = flat * KMODES_ZONE_COUNT // tile_palette_size  # [N,64]
    acc = np.zeros((n, KMODES_ZONE_COUNT), np.int64)
    np.add.at(acc, (np.arange(n)[:, None], zone_of), 1)
    thres = tile_palette_size // KMODES_ZONE_COUNT
    zones = (acc > thres).astype(np.uint8)
    return np.concatenate([tiles_pal.reshape(n, 64), zones],
                          axis=1).astype(np.uint8)


def compute_global_tiling_fwd(tiles_pal: np.ndarray, tile_active: np.ndarray,
                              tile_use: np.ndarray, tile_dpi: np.ndarray,
                              cfg, desired_tiles: int, mesh=None):
    """Pure tileset-level KModes reduction over the GLOBAL tile arrays.

    Returns (fwd, new_use, new_active, merges). Deterministic, so every
    host of a multi-host encode computes the identical map from the
    allgathered tileset (parallel.gop_exact); when `mesh` is given the
    per-bin solves run through the distributed solver
    (parallel.sharded_ops.sharded_kmodes — bit-identical by test)."""
    act = np.flatnonzero(tile_active)
    sigs = tile_signatures(tiles_pal[act], cfg.tile_palette_size)
    dpi = tile_dpi[act]

    # bin by DitheringPalIndex; budget share ~ EqualQualityTileCount
    bin_sizes = np.bincount(np.maximum(dpi, 0), minlength=cfg.palette_count)
    eqtc = np.array([equal_quality_tile_count(s) for s in bin_sizes])
    share = desired_tiles / max(eqtc.sum(), 1)
    cluster_counts = np.ceil(eqtc * share).astype(np.int64)

    # collect non-trivial bins, solve them all in one vmapped device call
    jobs = []
    for p in range(cfg.palette_count):
        sel = np.flatnonzero(dpi == p)
        n_bin, k = len(sel), int(cluster_counts[p])
        if n_bin == 0 or n_bin <= k or k == 0:
            continue
        bin_sigs = sigs[sel]
        # starting point: line with the smallest byte sum (last min wins,
        # main.pas:4301-4308 uses <=); kmodes_restarts > 0 requests
        # best-of-N golden-ratio restarts instead (kmodes.pas:949-966)
        sums = bin_sigs.astype(np.int64).sum(1)
        mins = np.flatnonzero(sums == sums.min())
        start = (-cfg.kmodes_restarts if cfg.kmodes_restarts > 0
                 else int(mins[-1]))
        jobs.append(dict(p=p, sel=sel, sigs=bin_sigs, k=k, start=start))
    if mesh is not None:
        from ..parallel.sharded_ops import sharded_kmodes
        solved = [sharded_kmodes(mesh, j['sigs'], j['k'], j['start'],
                                 cfg.tile_palette_size) for j in jobs]
    else:
        from ..ops.kmodes import kmodes_batch
        solved = kmodes_batch([j['sigs'] for j in jobs],
                              [j['k'] for j in jobs],
                              [j['start'] for j in jobs],
                              cfg.tile_palette_size)

    merges = 0
    fwd = np.arange(len(tiles_pal))
    new_use = tile_use.copy()
    new_active = tile_active.copy()
    for job, (labels, cents) in zip(jobs, solved):
        sel, bin_sigs, k = job['sel'], job['sigs'], job['k']
        # replace each cluster by its member closest to the centroid
        global_idx = act[sel]
        for j in range(k):
            members = np.flatnonzero(labels == j)
            if len(members) < 2:
                continue
            win_local = min_dissim_index_last(bin_sigs[members], cents[j])
            winner = global_idx[members[win_local]]
            loser_mask = np.ones(len(members), bool)
            loser_mask[win_local] = False
            losers = global_idx[members[loser_mask]]
            new_use[winner] += new_use[losers].sum()
            new_use[losers] = 0
            new_active[losers] = False
            fwd[losers] = winner  # winners stay active: no chains
            merges += len(losers)
    return fwd, new_use, new_active, merges


def _signatures_device_jit():
    global _sig_dev_fn
    if _sig_dev_fn is None:
        import functools

        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=('palette_size',))
        def kernel(tiles_u8, act_idx, palette_size: int):
            flat = tiles_u8[act_idx].reshape(act_idx.shape[0], 64) \
                .astype(jnp.int32)
            zone_of = flat * KMODES_ZONE_COUNT // palette_size
            acc = jnp.sum(
                (zone_of[:, :, None] ==
                 jnp.arange(KMODES_ZONE_COUNT)[None, None, :]
                 ).astype(jnp.int32), axis=1)
            thres = palette_size // KMODES_ZONE_COUNT
            zones = (acc > thres).astype(jnp.uint8)
            sigs = jnp.concatenate(
                [flat.astype(jnp.uint8), zones], axis=1)
            return sigs, jnp.sum(sigs.astype(jnp.int32), axis=1)

        _sig_dev_fn = kernel
    return _sig_dev_fn


_sig_dev_fn = None


def compute_global_tiling_fwd_device(state: EncoderState, cfg,
                                     desired_tiles: int):
    """Device-resident variant of compute_global_tiling_fwd: signatures,
    KModes solves and per-cluster winner selection all run on device
    against state's tiles_pal mirror; only labels/winners (small) come
    down. Identical fwd/use/active results (tested vs the host path)."""
    import time

    import jax.numpy as jnp
    phases = {}
    t0 = time.perf_counter()
    n = state.n_tiles
    act = np.flatnonzero(state.tile_active)
    a_pad = 1 << max(8, (act.size - 1).bit_length())
    act_p = np.full(a_pad, n, np.int32)  # sentinel: clamps to last row
    act_p[:act.size] = act
    from ..parallel.mesh_pipeline import mesh_ok
    from ..utils.dispatch import note
    note('h2d')
    note('jit')
    note('d2h')
    if mesh_ok(state.mesh):
        # row-parallel signature build sharded across the mesh (pure
        # integer math — identical values, so streams are unchanged)
        from ..parallel.mesh_pipeline import signatures_sharded
        sigs_dev, sums_dev = signatures_sharded(
            state.mesh, state.device_tiles_pal(), act_p,
            cfg.tile_palette_size)
    else:
        sigs_dev, sums_dev = _signatures_device_jit()(
            state.device_tiles_pal(), jnp.asarray(act_p),
            cfg.tile_palette_size)
    sums = np.asarray(sums_dev)[:act.size].astype(np.int64)
    dpi = state.tile_dpi[act]

    bin_sizes = np.bincount(np.maximum(dpi, 0), minlength=cfg.palette_count)
    eqtc = np.array([equal_quality_tile_count(s) for s in bin_sizes])
    share = desired_tiles / max(eqtc.sum(), 1)
    cluster_counts = np.ceil(eqtc * share).astype(np.int64)

    jobs = []
    for p in range(cfg.palette_count):
        sel = np.flatnonzero(dpi == p)
        n_bin, k = len(sel), int(cluster_counts[p])
        if n_bin == 0 or n_bin <= k or k == 0:
            continue
        s = sums[sel]
        mins = np.flatnonzero(s == s.min())
        # kmodes_restarts > 0 requests best-of-N golden-ratio restarts
        # (kmodes.pas:949-966) instead of the single min-byte-sum start
        start = (-cfg.kmodes_restarts if cfg.kmodes_restarts > 0
                 else int(mins[-1]))
        jobs.append(dict(sel=sel, k=k, start=start))
    phases['sigs_bins'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()

    from ..ops.kmodes import kmodes_batch_gather
    iters: list = []
    solved = kmodes_batch_gather(
        sigs_dev, [j['sel'].astype(np.int32) for j in jobs],
        [j['k'] for j in jobs], [j['start'] for j in jobs],
        cfg.tile_palette_size, iters_out=iters, need_cents=False)
    phases['solve'] = round(time.perf_counter() - t0, 3)
    state.metrics['gt_iters'] = iters
    t0 = time.perf_counter()

    merges = 0
    fwd = np.arange(n)
    new_use = state.tile_use.copy()
    new_active = state.tile_active.copy()
    for job, (labels, _cents, winner) in zip(jobs, solved):
        sel, k = job['sel'], job['k']
        global_idx = act[sel]
        members = np.bincount(labels, minlength=k)
        merged = members >= 2
        if not merged.any():
            continue
        win_global = np.where(winner >= 0, global_idx[winner], 0)
        use_sum = np.bincount(labels, weights=new_use[global_idx],
                              minlength=k).astype(np.int64)
        is_loser = merged[labels] & (global_idx != win_global[labels])
        losers = global_idx[is_loser]
        fwd[losers] = win_global[labels[is_loser]]
        new_use[win_global[merged]] += (use_sum
                                        - new_use[win_global])[merged]
        new_use[losers] = 0
        new_active[losers] = False
        merges += len(losers)
    phases['merge_host'] = round(time.perf_counter() - t0, 3)
    state.metrics['gt_phases'] = phases
    return fwd, new_use, new_active, merges


def run_global_tiling(state: EncoderState,
                      desired_tiles: int | None = None,
                      gts_out: str | None = None) -> EncoderState:
    cfg = state.config
    if cfg.reload_tileset:
        return run_reload_tiling(state, cfg.reload_tileset)

    if desired_tiles is None:
        raw = state.n_frames * state.tilemap_size
        budget = cfg.max_tiles if cfg.max_tiles > 0 else \
            round(cfg.qb_tiles * equal_quality_tile_count(raw))
        desired_tiles = min(budget, raw)

    import os

    from ..parallel.mesh_pipeline import mesh_ok
    if mesh_ok(state.mesh) and (cfg.mesh_kmodes or
                                os.environ.get('TILER_MESH_KMODES') == '1'):
        # opt-in distributed per-bin KModes (sharded_ops.sharded_kmodes,
        # bit-identical at 1/2/8 devices by test; config.mesh_kmodes or
        # the TILER_MESH_KMODES=1 env override). NOT the mesh default:
        # even with the solver compile cache (which took this path from
        # 41.8 s to 3.5 s on the 8-device CPU mesh) the sequential
        # per-bin solves still trail the vmapped super-shape batch
        # solver (2.5 s) — the bins are many and small, and vmap lanes
        # already fill one device. On real multi-GPU hardware with
        # large bins the distributed solve may win; multi-host encodes
        # reach it through parallel.gop_exact either way.
        fwd, new_use, new_active, merges = compute_global_tiling_fwd(
            state.tiles_pal, state.tile_active, state.tile_use,
            state.tile_dpi, cfg, desired_tiles, mesh=state.mesh)
    elif state._tiles_pal_dev is not None and state._tiles_pal_host is None:
        fwd, new_use, new_active, merges = compute_global_tiling_fwd_device(
            state, cfg, desired_tiles)
    else:
        fwd, new_use, new_active, merges = compute_global_tiling_fwd(
            state.tiles_pal, state.tile_active, state.tile_use,
            state.tile_dpi, cfg, desired_tiles)
    state.tile_use = new_use
    state.tile_active = new_active
    state.tm_tile = fwd[state.tm_tile].astype(np.int32)
    state.metrics['global_tiling_merged'] = merges
    import time
    t0 = time.perf_counter()
    run_make_unique(state)
    t1 = time.perf_counter()
    run_reindex(state)
    if 'gt_phases' in state.metrics:
        state.metrics['gt_phases']['unique_reindex'] = round(
            time.perf_counter() - t0, 3)
        state.metrics['gt_phases']['gt_unique'] = round(t1 - t0, 3)
        state.metrics['gt_phases']['gt_reindex'] = round(
            time.perf_counter() - t1, 3)
        state.metrics['gt_phases']['gt_mu'] = state.metrics.get(
            'mu_phases')
    if gts_out:
        n_active = int(state.tile_active.sum())
        write_gts(gts_out, state.tiles_pal[:n_active],
                  cfg.tile_palette_size)
    return state


def run_reload_tiling(state: EncoderState, gts_path: str) -> EncoderState:
    """ReloadPreviousTiling: overwrite each active tile's pixels with the
    nearest tile from a previous GTS tileset, matched on signatures within
    the same PalSigni bin when possible (main.pas:4372-4470)."""
    cfg = state.config
    gts_tiles, gts_pal_size = read_gts(gts_path)
    # rescale palette indices to the current palette size (main.pas:4436-4438)
    scaled = (gts_tiles.astype(np.int64) * cfg.tile_palette_size
              // gts_pal_size).astype(np.uint8)
    ds_sigs = tile_signatures(scaled, cfg.tile_palette_size)
    # PalSigni of dataset lines: min over zones of (64 - zone count)
    ds_signi = _pal_signi(scaled, cfg.tile_palette_size)

    act = np.flatnonzero(state.tile_active)
    sigs = tile_signatures(state.tiles_pal[act], cfg.tile_palette_size)
    signi = _pal_signi(state.tiles_pal[act], cfg.tile_palette_size)

    bins: dict[int, np.ndarray] = {}
    for s in np.unique(ds_signi):
        bins[int(s)] = np.flatnonzero(ds_signi == s)

    def batch_match(queries: np.ndarray, pool: np.ndarray) -> np.ndarray:
        """Vectorized GetMinMatchingDissim with the reference's last-min
        tie-break (kmodes.pas uses <=)."""
        out = np.empty(len(queries), np.int64)
        p = pool.astype(np.int64)
        for lo in range(0, len(queries), 1024):
            hi = min(len(queries), lo + 1024)
            q = queries[lo:hi].astype(np.int64)[:, None, :]
            d = (((q != p[None]).sum(-1) << 11)
                 + np.abs(q - p[None]).sum(-1))
            out[lo:hi] = d.shape[1] - 1 - np.argmin(d[:, ::-1], axis=1)
        return out

    for s in np.unique(signi):
        rows = np.flatnonzero(signi == s)
        cand = bins.get(int(s))
        if cand is not None and len(cand):
            pool_sigs, pool_tiles = ds_sigs[cand], scaled[cand]
        else:
            pool_sigs, pool_tiles = ds_sigs, scaled
        j = batch_match(sigs[rows], pool_sigs)
        state.tiles_pal[act[rows]] = pool_tiles[j]
    state.drop_tiles_pal_dev()  # in-place host mutation above

    run_make_unique(state)
    return state


def _pal_signi(tiles_pal: np.ndarray, tile_palette_size: int) -> np.ndarray:
    n = tiles_pal.shape[0]
    flat = tiles_pal.reshape(n, 64).astype(np.int64)
    zone_of = flat * KMODES_ZONE_COUNT // tile_palette_size
    acc = np.zeros((n, KMODES_ZONE_COUNT), np.int64)
    np.add.at(acc, (np.arange(n)[:, None], zone_of), 1)
    return (64 - acc).min(axis=1)
