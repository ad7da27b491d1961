"""MakeUnique step: merge exactly-identical dithered tiles.

Reference: MakeTilesUnique (/root/reference/main.pas:2555-2612) sorts tiles
by PalPixels bytes in 25-tilemap chunks and merges runs of equal tiles
(MergeTiles main.pas:3684-3712, tilemap forwarding main.pas:3722-3734).

Here the dedup is one global np.unique over the [N,64] byte matrix (a
superset of the reference's chunked dedup — the reference itself finishes
with a global MakeTilesUnique inside GlobalTiling, main.pas:4347). Winner =
lowest tile index of each group; use counts accumulate; tilemap references
forward to winners.

The tileset-level computation is a pure function (compute_unique_fwd) so
the multi-host encode can run it identically on every host over the
allgathered global tileset (parallel.gop_exact).
"""
from __future__ import annotations

import functools

import numpy as np

from .state import EncoderState


def tile_words(tiles_u8, idx):
    """Gather [R] tile rows as [R,16] big-endian u32 words (word order ==
    row byte order). Shared by the single-device dedup kernel and the
    mesh-distributed one (parallel.sharded_ops.sharded_unique) — the two
    must stay byte-compatible or mesh streams diverge."""
    import jax.numpy as jnp
    rows = tiles_u8[idx].reshape(idx.shape[0], 16, 4)
    w = rows.astype(jnp.uint32)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | \
           (w[..., 2] << 8) | w[..., 3]


def dedupe_words(words, idx):
    """Group byte-equal rows and pick each group's winner.

    words [R,16] u32 (tile_words), idx [R] i32 tile ids. Lexicographic
    sort as 16 LSD-radix passes of STABLE single-key sorts (a single
    17-operand lax.sort comparator compiles pathologically slowly),
    group equal rows, winner = lowest id per group. Returns
    (sidx_sorted, winner_sorted) pairs for the host scatter. THE shared
    dedup core: the single-device MakeUnique kernel and each shard of
    the distributed one trace this same function."""
    import jax
    import jax.numpy as jnp
    r = words.shape[0]
    perm = jnp.arange(r, dtype=jnp.int32)
    for i in reversed(range(16)):
        _, perm = jax.lax.sort((jnp.take(words[:, i], perm), perm),
                               num_keys=1, is_stable=True)
    sw = jnp.take(words, perm, axis=0)
    sidx = jnp.take(idx, perm)
    new = jnp.concatenate([
        jnp.ones(1, bool),
        jnp.any(sw[1:] != sw[:-1], axis=1)])
    gid = jnp.cumsum(new.astype(jnp.int32)) - 1
    winner_of_group = jax.ops.segment_min(sidx, gid, num_segments=r)
    return sidx, winner_of_group[gid]


@functools.lru_cache(maxsize=1)
def _unique_fwd_dev_jit():
    import jax

    @jax.jit
    def kernel(tiles_u8, act_idx):
        """Device dedup: gather the [A,64] active rows, group equal
        rows, winner = lowest original tile index per group. Returns
        (tile index, its winner) pairs in sorted order for the host
        scatter."""
        return dedupe_words(tile_words(tiles_u8, act_idx), act_idx)

    return kernel


def compute_unique_fwd(tiles_pal: np.ndarray, tile_active: np.ndarray,
                       tile_use: np.ndarray):
    """Pure tileset-level dedup over the GLOBAL tile arrays.

    Returns (fwd [N] forwarding map, new_use [N], new_active [N],
    losers index array) without touching any tilemap."""
    n = len(tiles_pal)
    fwd = np.arange(n)
    act = np.flatnonzero(tile_active)
    if act.size == 0:
        return fwd, tile_use.copy(), tile_active.copy(), act
    keys = tiles_pal[act].reshape(len(act), -1)
    _, first_idx, inverse = np.unique(keys, axis=0, return_index=True,
                                      return_inverse=True)
    winners = act[first_idx][inverse]  # per active tile: its group winner

    fwd[act] = winners
    new_use = tile_use.copy()
    acc = np.bincount(winners, weights=tile_use[act],
                      minlength=n).astype(np.int64)
    losers = act[winners != act]
    new_use[act] = 0
    new_use += acc
    new_active = tile_active.copy()
    new_active[losers] = False
    return fwd, new_use, new_active, losers


def compute_unique_fwd_device(state: EncoderState):
    """compute_unique_fwd against the device-resident tiles: the [A,64]
    rows never leave the device; only the (tile, winner) pairs come down.

    Under a production mesh the dedup runs DISTRIBUTED: rows
    hash-partition across the devices (one all_to_all) and each shard
    radix-dedups its partition (parallel.sharded_ops.sharded_unique —
    the reference's chunked MakeUnique fan-out, main.pas:933, as a
    multi-device program). The winner map is canonical (min tile index
    per byte-equal group), so the stream is byte-identical either way."""
    import jax.numpy as jnp

    from ..parallel.mesh_pipeline import mesh_ok
    n = state.n_tiles
    fwd = np.arange(n)
    act = np.flatnonzero(state.tile_active)
    if act.size == 0:
        return fwd, state.tile_use.copy(), state.tile_active.copy(), act
    import time

    from ..utils.dispatch import note
    if mesh_ok(state.mesh):
        from ..parallel.sharded_ops import sharded_unique
        note('h2d', 2)
        note('jit', 2)
        note('d2h', 3)
        t0 = time.perf_counter()
        sidx, winner = sharded_unique(
            state.mesh, state.device_tiles_pal(), act, n)
        t_queue, a_pad = time.perf_counter() - t0, len(sidx)
        t0 = time.perf_counter()
    else:
        # pow2-pad with sentinel index n: the gather clamps to the last
        # row (duplicating its bytes — harmless, min-index winner still
        # real) and the host scatter filters the sentinels out. Bounded
        # compile count.
        a_pad = 1 << max(8, (act.size - 1).bit_length())
        act_p = np.full(a_pad, n, np.int32)
        act_p[:act.size] = act
        note('h2d')
        note('jit')
        note('d2h', 2)
        t0 = time.perf_counter()
        sidx, winner = _unique_fwd_dev_jit()(
            state.device_tiles_pal(), jnp.asarray(act_p))
        t_queue = time.perf_counter() - t0
        t0 = time.perf_counter()
        sidx = np.asarray(sidx)
        winner = np.asarray(winner)
    # queue vs sync split: the sync includes the D2H of the (tile,
    # winner) pairs
    state.metrics['mu_phases'] = {
        'queue': round(t_queue, 3),
        'sync': round(time.perf_counter() - t0, 3),
        'rows': int(a_pad)}
    valid = sidx < n
    fwd[sidx[valid]] = winner[valid]

    tile_use = state.tile_use
    new_use = tile_use.copy()
    acc = np.bincount(fwd[act], weights=tile_use[act],
                      minlength=n).astype(np.int64)
    losers = act[fwd[act] != act]
    new_use[act] = 0
    new_use += acc
    new_active = state.tile_active.copy()
    new_active[losers] = False
    return fwd, new_use, new_active, losers


def run_make_unique(state: EncoderState) -> EncoderState:
    if state._tiles_pal_dev is not None and state._tiles_pal_host is None:
        fwd, new_use, new_active, losers = compute_unique_fwd_device(state)
        if losers.size:
            import jax.numpy as jnp

            from ..utils.dispatch import note
            note('h2d')
            note('eager')
            state.set_tiles_pal_device(
                state.device_tiles_pal().at[jnp.asarray(
                    losers.astype(np.int32))].set(0))
    else:
        fwd, new_use, new_active, losers = compute_unique_fwd(
            state.tiles_pal, state.tile_active, state.tile_use)
        state.tiles_pal[losers] = 0  # reference zeroes merged losers
        state.drop_tiles_pal_dev()
    state.tile_use = new_use
    state.tile_active = new_active

    state.tm_tile = fwd[state.tm_tile].astype(np.int32)
    if state.stm_tile is not None:
        state.stm_tile = fwd[state.stm_tile].astype(np.int32)
    state.metrics['unique_tiles'] = int(state.tile_active.sum())
    return state
