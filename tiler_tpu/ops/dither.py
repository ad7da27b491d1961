"""Ordered dithering: Thomas Knoll pattern dithering and Yliluoma-2 mixing
plans, batched over all pixels of all tiles.

Reference: DeviseBestMixingPlanThomasKnoll (/root/reference/main.pas:
1828-1875), DeviseBestMixingPlanYliluoma (main.pas:1573-1826, SSE3 inner
loop at 1602-1752), DitherTile (main.pas:1998-2068), per-color plan caches
(main.pas:2010-2053).

Design: the reference serializes per pixel and caches per color
behind spinlocks; here every pixel's 64-step Knoll plan is an independent
lax.scan lane — [n_pixels] lanes x [palette] penalty argmins per step, all
int32 on the VPU — so no cache, no locks, deterministic. The plan sort by
palette luma becomes a batched argsort; only the Bayer-selected rank is
gathered per pixel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DITHERING_MAP, TILE_W
from .color import color_compare_i32, jax_div_trunc

_BAYER = DITHERING_MAP.reshape(TILE_W, TILE_W)


def _pad_pow2(n: int, minimum: int = 256) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _pad_rows(arr, n_pad):
    if arr.shape[0] == n_pad:
        return arr
    return np.concatenate(
        [arr, np.zeros((n_pad - arr.shape[0],) + arr.shape[1:], arr.dtype)])


@jax.jit
def _knoll_chunk(tiles_u8, pal_u8):
    """Fused per-chunk Knoll dither: [C,8,8,3] u8 + [C,S,3] u8 -> [C,8,8]
    u8 — one dispatch, uint8 transfers only."""
    c = tiles_u8.shape[0]
    t = tiles_u8.astype(jnp.int32)
    pal = pal_u8.astype(jnp.int32)
    luma = (pal[..., 0] * 2126 + pal[..., 1] * 7152 + pal[..., 2] * 722)
    cols = t.reshape(c * 64, 3)
    pal_px = jnp.repeat(pal, 64, axis=0)
    counts = _knoll_counts(cols, pal_px)  # [C*64, S]
    order = jnp.argsort(luma, axis=1, stable=True)  # [C,S]
    order_px = jnp.repeat(order, 64, axis=0)
    rank = jnp.tile(jnp.asarray(_BAYER.reshape(-1)), (c,))  # [C*64]
    sel = _rank_select(counts, order_px, rank)
    return sel.astype(jnp.uint8).reshape(c, TILE_W, TILE_W)


def _knoll_counts(cols, pal):
    """cols [M,3] i32 pixels; pal [M,S,3] i32 per-pixel palette. Returns
    [M,S] i32: how many of the 64 Knoll plan steps chose each palette index.

    The luma-sorted plan (PlanCompareLuma, main.pas:1544-1555) is a
    multiset ordered by each entry's palette luma, so it is fully
    determined by these counts plus the palette's luma order — no [M,64]
    plan buffer, no per-row argsort, no per-step gather. Tie divergence:
    two DISTINCT palette entries with exactly equal weighted luma would
    interleave by plan position in the reference but group by index here
    (exact-duplicate entries are unaffected: the strict-< argmin always
    picks the lowest duplicate index)."""
    s = cols.astype(jnp.int32)
    s_size = pal.shape[1]
    iota = jnp.arange(s_size, dtype=jnp.int32)[None, :]

    def step(carry, _):
        e, counts = carry
        t = s + jax_div_trunc(e * 9, 100)
        pens = color_compare_i32(t[:, None, :], pal)  # [M,S]
        chosen = jnp.argmin(pens, axis=1)  # first min wins, as in Pascal
        oh = (iota == chosen[:, None])
        picked = jnp.sum(pal * oh[..., None], axis=1)
        e = e + s - picked
        return (e, counts + oh.astype(jnp.int32)), None

    e0 = jnp.zeros_like(s)
    c0 = jnp.zeros((s.shape[0], s_size), jnp.int32)
    (_, counts), _ = jax.lax.scan(step, (e0, c0), None, length=64)
    return counts


def _rank_select(counts, order, rank):
    """Select sorted-plan entry at `rank` from per-index counts.

    counts [..., S] i32 (sums to the plan length), order [..., S] i32
    (palette indices luma-ascending), rank [...] i32. Entry r of the
    sorted plan is the luma-rank j whose cumulative count range covers r:
    j = #{ranks with inclusive-cumsum <= r}."""
    cnt_sorted = jnp.take_along_axis(counts, order, axis=-1)
    cum = jnp.cumsum(cnt_sorted, axis=-1)
    j = jnp.sum((cum <= rank[..., None]).astype(jnp.int32), axis=-1)
    return jnp.take_along_axis(order, j[..., None], axis=-1)[..., 0]


def knoll_dither_tiles(tiles_rgb, palettes_rgb, chunk: int = 16384):
    """Dither tiles with the Knoll planner.

    tiles_rgb: [N,8,8,3] uint8; palettes_rgb: [N,S,3] uint8 (palette chosen
    per tile). Returns [N,8,8] uint8 palette indices.

    Each pixel's plan entry is picked at Bayer rank cDitheringMap[y*8+x]
    (main.pas:2012-2018). Chunked over tiles to bound the [M,64]-plan
    footprint.
    """
    tiles_rgb = np.asarray(tiles_rgb)
    palettes_rgb = np.asarray(palettes_rgb)
    n = tiles_rgb.shape[0]
    out = np.empty((n, TILE_W, TILE_W), np.uint8)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        c = hi - lo
        cp = _pad_pow2(c)
        res = _knoll_chunk(_pad_rows(tiles_rgb[lo:hi], cp),
                           _pad_rows(palettes_rgb[lo:hi], cp))
        out[lo:hi] = np.asarray(res)[:c]
    return out


@functools.partial(jax.jit, static_argnames=('mixed_colors',))
def _yliluoma_plans(cols, pal, luma_pal, mixed_colors: int):
    """Yliluoma-2 mixing plans (scalar semantics of main.pas:1753-1794).

    cols [M,3] i32; pal [M,S,3] i32; returns (plans [M,L] sorted by luma,
    counts [M]) with L = mixed_colors.
    """
    m, s_size, _ = pal.shape
    L = mixed_colors                  # loop runs while plan_count < L
    L_buf = max(2 * mixed_colors - 1, 1)  # plans can overshoot to 2L-2

    def step(carry, _):
        so_far, plan, plan_count = carry
        active = plan_count < L  # Pascal: while plan_count < Y2MixedColors
        max_test = jnp.maximum(plan_count, 1)  # [M]
        # candidate avg after adding `chosen` k times with the +1-per-step
        # ramp the reference applies to `add` (main.pas:1766-1772)
        t_rng = jnp.arange(1, L + 1)[None, None, :, None]  # k = t-plan_count
        add0 = pal[:, :, None, :]
        ramp = (t_rng * (t_rng - 1)) // 2
        sums = (so_far[:, None, None, :] + add0 * t_rng + ramp)
        tot = plan_count[:, None, None, None] + t_rng
        cand = sums // tot  # values are >= 0 so // == Pascal div
        pens = color_compare_i32(cols[:, None, None, :], cand)  # [M,S,L]
        t_idx = jnp.arange(L)[None, None, :]
        valid = t_idx < max_test[:, None, None]
        pens = jnp.where(valid, pens, jnp.int32(2**31 - 1))
        flat = pens.reshape(m, -1)  # palette-major, t-minor = Pascal order
        best = jnp.argmin(flat, axis=1)
        chosen = (best // L).astype(jnp.int32)
        amount = (best % L + 1).astype(jnp.int32)
        amount = jnp.where(active, amount, 0)
        picked = jnp.take_along_axis(pal, chosen[:, None, None], axis=1)[:, 0]
        pos = jnp.arange(L_buf)[None, :]
        write = (pos >= plan_count[:, None]) & \
            (pos < (plan_count + amount)[:, None])
        plan = jnp.where(write, chosen[:, None], plan)
        so_far = so_far + picked * amount[:, None]
        plan_count = plan_count + amount
        return (so_far, plan, plan_count), None

    so_far = jnp.zeros_like(cols)
    plan = jnp.zeros((m, L_buf), jnp.int32)
    plan_count = jnp.zeros((m,), jnp.int32)
    (so_far, plan, plan_count), _ = jax.lax.scan(
        step, (so_far, plan, plan_count), None, length=L)

    # sort only the first plan_count entries: entries beyond the count get
    # an infinite key so they sink to the end without affecting ranks
    keys = jnp.take_along_axis(luma_pal, plan, axis=1)
    pos = jnp.arange(L_buf)[None, :]
    keys = jnp.where(pos < plan_count[:, None], keys, jnp.int32(2**31 - 1))
    order = jnp.argsort(keys, axis=1, stable=True)
    plan = jnp.take_along_axis(plan, order, axis=1)
    return plan, plan_count


@jax.jit
def _dedup_keys(tiles_u8, pal_group):
    """Pack (group<<24 | b<<16 | g<<8 | r) uint32 pixel keys, sort them
    with pixel positions as payload, and emit the sort-join inverse map.

    Returns (keys [N,64] u32, sorted keys, inv [N*64] i32 = position of
    each pixel's key among the uniques, unique count). Producing inv here
    costs one scatter; a separate searchsorted over [N*64] queries fused
    into the assign kernel ran ~180ms at 1.2M pixels."""
    t = tiles_u8.astype(jnp.uint32)
    n = t.shape[0]
    keys = (t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16)).reshape(n, 64)
    keys = keys | (pal_group.astype(jnp.uint32)[:, None] << 24)
    flat = keys.reshape(-1)
    skeys, spos = jax.lax.sort(
        (flat, jnp.arange(flat.shape[0], dtype=jnp.int32)), num_keys=1)
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
    gid = jnp.cumsum(newgrp.astype(jnp.int32)) - 1
    inv = jnp.zeros(flat.shape[0], jnp.int32).at[spos].set(gid)
    return keys, skeys, inv, gid[-1] + 1


@functools.partial(jax.jit, static_argnames=('u_cap',))
def _compact_unique(skeys, u_cap: int):
    """Sorted keys -> [u_cap] u32 unique keys (padded with 0xFFFFFFFF)."""
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
    pos = jnp.cumsum(newgrp.astype(jnp.int32)) - 1
    idx = jnp.where(newgrp, pos, u_cap)  # dropped when == u_cap
    out = jnp.full(u_cap, jnp.uint32(0xFFFFFFFF))
    return out.at[idx].set(skeys, mode='drop')


@jax.jit
def _counts_from_keys(uniq_chunk, group_pals_u8):
    """Unique u32 keys -> Knoll plan counts [chunk, S] u8, on device."""
    cols = jnp.stack([uniq_chunk & 0xff, (uniq_chunk >> 8) & 0xff,
                      (uniq_chunk >> 16) & 0xff], 1).astype(jnp.int32)
    grp = (uniq_chunk >> 24).astype(jnp.int32)
    g = jnp.minimum(grp, group_pals_u8.shape[0] - 1)  # sentinel rows clamp
    pal = group_pals_u8[g].astype(jnp.int32)
    return _knoll_counts(cols, pal).astype(jnp.uint8)


@jax.jit
def _assign_counts(counts_u8, inv, keys, group_pals_u8):
    """Per-pixel Bayer-rank selection from dedup'd plan counts: gather
    each pixel's [S] counts by its precomputed unique position (inv from
    _dedup_keys' sort-join), rank-select at its Bayer position — all on
    device; only [N,64] u8 returns to host.

    The selection is GATHER-FREE past the row gather: sorted-plan entry r
    is the unique palette index t whose luma-ordered cumulative-count
    window covers r, and the cumulative counts C[:, :, t] come from one
    batched [64,S]x[S,S] matmul against the group's rank-comparison matrix
    instead of a take_along_axis along the minor dim. The counts are small
    integers and the matrix is 0/1, so every product and sum is an exact
    float32 integer at any matmul precision (no numerics-contract pin)."""
    n = keys.shape[0]
    s_size = counts_u8.shape[1]
    cnt = counts_u8[inv].astype(jnp.float32).reshape(n, 64, s_size)
    pal = group_pals_u8.astype(jnp.int32)
    luma = (pal[..., 0] * 2126 + pal[..., 1] * 7152 + pal[..., 2] * 722)
    order = jnp.argsort(luma, axis=1, stable=True)  # [G,S] tiny
    g = pal.shape[0]
    rank = jnp.zeros((g, s_size), jnp.int32).at[
        jnp.arange(g)[:, None], order].set(
        jnp.broadcast_to(jnp.arange(s_size, dtype=jnp.int32)[None, :],
                         (g, s_size)))
    # R[g, t, s] = 1 if index s sorts at-or-before index t in luma order
    R = (rank[:, None, :] <= rank[:, :, None]).astype(jnp.float32)
    grp = jnp.minimum((keys[:, 0] >> 24).astype(jnp.int32), g - 1)
    Rg = R[grp]  # [n,S,S] row gather (fast)
    C = jnp.einsum('nps,nts->npt', cnt, Rg,
                   preferred_element_type=jnp.float32)  # cumulative counts
    low = C - cnt  # window start of index t (counts are exact in f32)
    r = jnp.asarray(DITHERING_MAP.reshape(-1).astype(np.float32))
    hit = (low <= r[None, :, None]) & (r[None, :, None] < C)
    iota = jnp.arange(s_size, dtype=jnp.int32)
    sel = jnp.sum(jnp.where(hit, iota[None, None, :], 0), axis=-1)
    return sel.astype(jnp.uint8)


def knoll_dither_tiles_cached(tiles_rgb, group_pals, pal_group,
                              chunk: int = 262144,
                              return_device: bool = False,
                              mesh=None):
    """Knoll dithering with plan deduplication — the batched equivalent of
    the reference's per-color plan caches (main.pas:2010-2053).

    Plans depend only on (palette, color); natural video repeats colors
    heavily, so plans are computed once per unique (pal_group, color) pair
    and gathered per pixel at its Bayer rank. The dedup (pack, sort,
    compaction, inverse lookup) runs entirely on device — only the tiles
    (u8) and group ids go up, and the final [N,8,8] u8 comes back.

    group_pals: [G,S,3] uint8 distinct palettes, G <= 256;
    pal_group: [N] int ids into group_pals per tile.
    """
    group_pals = np.asarray(group_pals, np.uint8)
    n = tiles_rgb.shape[0]
    if n == 0:
        return np.zeros((0, TILE_W, TILE_W), np.uint8)
    assert group_pals.shape[0] <= 256, 'pal_group must fit 8 bits'

    # device-resident tiles pass through untouched (no round trip)
    from ..utils.dispatch import note
    tiles_d = tiles_rgb if isinstance(tiles_rgb, jnp.ndarray) \
        else jnp.asarray(np.asarray(tiles_rgb))
    group_d = pal_group if isinstance(pal_group, jnp.ndarray) \
        else jnp.asarray(np.asarray(pal_group, np.int32))
    note('jit', 2)
    note('d2h')
    keys, skeys, inv, count = _dedup_keys(tiles_d, group_d)
    u = int(count)  # one scalar sync
    u_cap = _pad_pow2(u, minimum=256)
    uniq = _compact_unique(skeys, u_cap)

    # mesh path: the plan-count and rank-selection halves are row-parallel
    # and shard across the encoder mesh (parallel.mesh_pipeline); only the
    # color-dedup sort above stays on one device. Identical bytes.
    if mesh is not None:
        from ..parallel import mesh_pipeline as mp
        if not mp.mesh_ok(mesh):
            mesh = None
    note('h2d')
    pals_d = jnp.asarray(group_pals)
    pals_rep = mp.replicate(mesh, pals_d) if mesh is not None else None
    plan_parts = []
    for lo in range(0, u_cap, chunk):
        hi = min(u_cap, lo + chunk)
        note('jit')
        if mesh is not None:
            plan_parts.append(
                mp.knoll_counts_sharded(mesh, uniq[lo:hi], pals_rep))
        else:
            plan_parts.append(_counts_from_keys(uniq[lo:hi], pals_d))
    counts_dev = jnp.concatenate(plan_parts) if len(plan_parts) > 1 \
        else plan_parts[0]
    counts_rep = mp.replicate(mesh, counts_dev) if mesh is not None \
        else None
    # assign in pow2-padded tile chunks: the [C,64,S] gather intermediate
    # stays bounded and shapes bucket (no per-size recompiles)
    parts = []
    inv2d = inv.reshape(n, 64)
    # 262144-tile chunks: the [C*64, S] u8 selection intermediate stays
    # ~268 MB and a 475k-tile CIF clip takes 2 dispatches instead of 8
    tchunk = 262144
    for lo in range(0, n, tchunk):
        hi = min(n, lo + tchunk)
        note('jit')
        cp = _pad_pow2(hi - lo)
        kchunk = keys[lo:hi]
        if cp != hi - lo:
            kchunk = jnp.pad(kchunk, ((0, cp - (hi - lo)), (0, 0)))
        if mesh is not None:
            i2chunk = inv2d[lo:hi]
            if cp != hi - lo:
                i2chunk = jnp.pad(i2chunk, ((0, cp - (hi - lo)), (0, 0)))
            parts.append(mp.knoll_assign_sharded(
                mesh, counts_rep, i2chunk, kchunk, pals_rep)[:hi - lo])
        else:
            ichunk = inv2d[lo:hi].reshape(-1)
            if cp != hi - lo:
                ichunk = jnp.pad(ichunk, (0, (cp - (hi - lo)) * 64))
            parts.append(_assign_counts(counts_dev, ichunk, kchunk,
                                        pals_d)[:hi - lo])
    sel = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    if mesh is not None:
        # back to a single-device array: downstream (.at[].set into the
        # unsharded tile buffer, mirror canonicalization) runs unsharded
        import jax
        sel = jax.device_put(sel, jax.devices()[0])
    if return_device:
        return sel.reshape(n, TILE_W, TILE_W)
    return np.asarray(sel).reshape(n, TILE_W, TILE_W)


@functools.partial(jax.jit, static_argnames=('mixed_colors',))
def _yil_plans_from_keys(uniq_chunk, group_pals_u8, mixed_colors: int):
    """Unique u32 (group|color) keys -> (sorted Yliluoma plans [chunk,
    2L-1] u8, counts [chunk] u8), on device."""
    cols = jnp.stack([uniq_chunk & 0xff, (uniq_chunk >> 8) & 0xff,
                      (uniq_chunk >> 16) & 0xff], 1).astype(jnp.int32)
    grp = (uniq_chunk >> 24).astype(jnp.int32)
    g = jnp.minimum(grp, group_pals_u8.shape[0] - 1)  # sentinel rows clamp
    pal = group_pals_u8[g].astype(jnp.int32)
    luma = (pal[..., 0] * 2126 + pal[..., 1] * 7152 + pal[..., 2] * 722)
    plans, counts = _yliluoma_plans(cols, pal, luma, mixed_colors)
    return plans.astype(jnp.uint8), counts.astype(jnp.uint8)


@jax.jit
def _assign_plans_yil(plans_u8, counts_u8, inv2d):
    """Per-pixel Yliluoma pick list[(bayer*count)>>6] from the sort-join
    inverse — all on device. The minor-dim plan pick is a one-hot
    compare+sum instead of a take_along_axis on the minor dim."""
    bayer = jnp.asarray(DITHERING_MAP.reshape(-1).astype(np.int32))
    counts = counts_u8[inv2d].astype(jnp.int32)
    mv = (bayer[None, :] * counts) >> 6
    rows = plans_u8[inv2d].astype(jnp.int32)  # [N,64,L]
    lbuf = rows.shape[-1]
    oh = (jnp.arange(lbuf, dtype=jnp.int32)[None, None, :] ==
          mv[..., None])
    return jnp.sum(jnp.where(oh, rows, 0), axis=-1).astype(jnp.uint8)


def yliluoma_dither_tiles_cached(tiles_rgb, group_pals, pal_group,
                                 mixed_colors: int = 4,
                                 chunk: int = 131072,
                                 return_device: bool = False):
    """Yliluoma-2 dithering with plan deduplication per (palette, color) —
    the same treatment as knoll_dither_tiles_cached: mixing plans depend
    only on the palette and the source color (the reference caches them
    per color behind a spinlock, main.pas:2010-2053), so compute one plan
    per unique (pal_group, color) pair on device and gather per pixel.
    Only u8 tiles + group ids go up; [N,8,8] u8 comes back."""
    group_pals = np.asarray(group_pals, np.uint8)
    n = tiles_rgb.shape[0]
    if n == 0:
        return np.zeros((0, TILE_W, TILE_W), np.uint8)
    assert group_pals.shape[0] <= 256, 'pal_group must fit 8 bits'

    tiles_d = tiles_rgb if isinstance(tiles_rgb, jnp.ndarray) \
        else jnp.asarray(np.asarray(tiles_rgb))
    group_d = pal_group if isinstance(pal_group, jnp.ndarray) \
        else jnp.asarray(np.asarray(pal_group, np.int32))
    keys, skeys, inv, count = _dedup_keys(tiles_d, group_d)
    u = int(count)  # one scalar sync
    u_cap = _pad_pow2(u, minimum=256)
    uniq = _compact_unique(skeys, u_cap)

    pals_d = jnp.asarray(group_pals)
    plan_parts, count_parts = [], []
    for lo in range(0, u_cap, chunk):
        hi = min(u_cap, lo + chunk)
        p, c = _yil_plans_from_keys(uniq[lo:hi], pals_d, mixed_colors)
        plan_parts.append(p)
        count_parts.append(c)
    plans_dev = jnp.concatenate(plan_parts) if len(plan_parts) > 1 \
        else plan_parts[0]
    counts_dev = jnp.concatenate(count_parts) if len(count_parts) > 1 \
        else count_parts[0]
    out = _assign_plans_yil(plans_dev, counts_dev, inv.reshape(n, 64))
    if return_device:
        return out.reshape(n, TILE_W, TILE_W)
    return np.asarray(out).reshape(n, TILE_W, TILE_W)


def yliluoma_dither_tiles(tiles_rgb, palettes_rgb, mixed_colors: int = 4,
                          chunk: int = 8192):
    """Yliluoma-2 dithering (main.pas:2055-2066): per pixel, pick
    list[(bayer*count)>>6] from the luma-sorted mixing plan."""
    tiles_rgb = np.asarray(tiles_rgb)
    palettes_rgb = np.asarray(palettes_rgb)
    from .color import luma_raw
    n = tiles_rgb.shape[0]
    bayer_flat = jnp.asarray(_BAYER.reshape(-1))
    out = np.empty((n, TILE_W, TILE_W), np.uint8)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        c = hi - lo
        cp = _pad_pow2(c)
        t = jnp.asarray(_pad_rows(tiles_rgb[lo:hi], cp), jnp.int32)
        palc = _pad_rows(palettes_rgb[lo:hi], cp)
        pal = jnp.repeat(jnp.asarray(palc, jnp.int32), 64, axis=0)
        luma = jnp.repeat(jnp.asarray(luma_raw(palc), jnp.int32), 64, axis=0)
        cols = t.reshape(cp * 64, 3)
        plans, counts = _yliluoma_plans(cols, pal, luma, mixed_colors)
        mv = (jnp.tile(bayer_flat, (cp,)) * counts) >> 6
        sel = jnp.take_along_axis(plans, mv[:, None], axis=1)[:, 0]
        out[lo:hi] = np.asarray(sel, np.uint8).reshape(
            cp, TILE_W, TILE_W)[:c]
    return out


def dither_tile_floyd_steinberg(tile_rgb: np.ndarray,
                                bits_per_comp: int = 8) -> np.ndarray:
    """Per-tile FS error diffusion with edge-clamped borders
    (DitherTileFloydSteinberg, main.pas:1877-1929). Used by the VAR
    quantizer's histogram when cBitsPerComp < 8."""
    from .. import native
    if native.available():
        return native.fs_tile(tile_rgb, bits_per_comp)
    cvt_pre = (1 << bits_per_comp) - 1
    cvt_post = 256 // cvt_pre
    px = np.zeros((TILE_W + 2, TILE_W + 2, 3), np.int64)
    px[1:9, 1:9] = tile_rgb
    px[1:9, 0] = px[1:9, 1]
    px[1:9, 9] = px[1:9, 8]
    px[0] = px[1]
    px[9] = px[8]
    for y in range(1, TILE_W + 1):
        for x in range(1, TILE_W + 1):
            for c in range(3):
                old = px[y, x, c]
                new = min(255, ((old * cvt_pre) // 255) * cvt_post)
                err = old - new
                px[y, x, c] = new
                px[y, x + 1, c] += (err * 7) >> 4
                px[y + 1, x - 1, c] += (err * 3) >> 4
                px[y + 1, x, c] += (err * 5) >> 4
                px[y + 1, x + 1, c] += (err * 1) >> 4
    return np.minimum(px[1:9, 1:9], 255).astype(np.uint8)


def floyd_steinberg_posterize(frame_rgb: np.ndarray,
                              bits_per_comp: int = 8) -> np.ndarray:
    """Whole-frame serpentine-free FS error diffusion to bits_per_comp
    (DitherFloydSteinberg, main.pas:1966-1996).

    At the default cBitsPerComp=8 Posterize() is the identity and the error
    is always zero, so this returns the input unchanged — the reference runs
    the same loop with all-zero quant error. Below 8 bits the C++ port in
    tiler_tpu.native runs (the Python loop here is the oracle-tested
    fallback; ~2M interpreter steps per 1080p frame).

    Border semantics follow the reference exactly: at the last column/row
    the neighbor offsets collapse to 0, so the quantization error is added
    onto the just-written pixel itself (and onto already-processed
    neighbors on the last row), clamped 0..255 (main.pas:1976-1992).
    """
    if bits_per_comp >= 8:
        return frame_rgb
    from .. import native
    if native.available():
        return native.fs_posterize(frame_rgb, bits_per_comp)
    h, w, _ = frame_rgb.shape
    cvt_pre = (1 << bits_per_comp) - 1
    cvt_post = 256 // cvt_pre
    px = frame_rgb.astype(np.int32).reshape(-1).copy()
    stride = w * 3
    p = 0
    for y in range(h):
        for x in range(w):
            ypo = stride if y < h - 1 else 0
            xpo = 3 if x < w - 1 else 0
            xmo = -3 if x > 0 else 0
            for c in range(3):
                old = px[p]
                new = min(255, ((old * cvt_pre) // 255) * cvt_post)
                err = old - new
                px[p] = new
                for off, fac in ((xpo, 7), (ypo + xmo, 3), (ypo, 5),
                                 (ypo + xpo, 1)):
                    v = px[p + off] + ((err * fac) >> 4)
                    px[p + off] = 0 if v < 0 else (255 if v > 255 else v)
                p += 1
    return px.reshape(h, w, 3).astype(np.uint8)
