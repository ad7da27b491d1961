"""FrameTiling step: remap every tilemap cell to the best (tile, palette,
mirror) candidate from the reduced tileset.

Reference: PrepareGlobalFT (/root/reference/main.pas:3736-3780) builds a
64-dim kd-tree over active tiles x 4 mirror variants; PrepareFrameTiling
(main.pas:3791-3967) marks candidate combos per keyframe via 8-NN bucket
search expanded across palettes by quality level (UseOne main.pas:
3802-3853, palette-centroid distances BuildPaletteCorrTriangle main.pas:
3855-3867), then computes 192-dim PsyV features of every used combo
(DoPsyV main.pas:3883-3919) and 1-NN-searches each cell's source-tile
feature against them (DoFrameTiling main.pas:3992-4047).

Here both searches are exact streaming distance matmuls (ops.knn);
the per-keyframe lazy init/teardown critical sections and FramesLeft
refcounts (the reference's per-frame thread fan-out, main.pas:972)
disappear — the step runs as three BULK phases batched across keyframes:
one k-NN pass over every keyframe's marking queries, one feature pass
over every keyframe's candidate combos, then ONE device dispatch per
keyframe for the fused stage-3 (query features + streaming 1-NN), with a
single device->host download at the end. The schedule minimizes
host-device interactions; per-row math is unchanged, keeping the
stream bytes identical to the per-keyframe schedule. Dataset entry order
matches the reference's mirror walk (attrs 0,1,3,2 per tile) for
tie-compatibility.
"""
from __future__ import annotations

import functools

import jax
import numpy as np

from ..config import FTQuality
from ..constants import TILE_W
from ..ops import features, knn
from ..utils.dispatch import note
from .state import EncoderState

_ATTR_ORDER = np.array([0, 1, 3, 2], np.int32)  # h|v<<1 per dataset slot


def _ft_gamma(cfg):
    return cfg.encoder_gamma if cfg.ft_gamma else None


def _expand_mirrors(t_u8):
    """[A,8,8] u8 -> [4A,64] f32 mirror variants, on device. MODULE-LEVEL
    jit: a jit defined inside the calling function gets a fresh cache per
    call and recompiles every encode."""
    import jax.numpy as jnp
    variants = jnp.stack([
        t_u8,                    # attrs 0: no mirror
        t_u8[:, :, ::-1],        # attrs 1: H
        t_u8[:, ::-1, ::-1],     # attrs 3: HV
        t_u8[:, ::-1, :],        # attrs 2: V
    ], axis=1)  # [A,4,8,8]
    return variants.reshape(-1, TILE_W * TILE_W).astype(jnp.float32)


def build_global_dataset(state: EncoderState):
    """[4A, 64] float32 mirrored PalPixels (device-resident; the u8 tiles
    upload once and the 4 mirror variants are built on device) + maps to
    (tile, attrs)."""
    import jax
    import jax.numpy as jnp
    global _expand_jit
    if _expand_jit is None:
        _expand_jit = jax.jit(_expand_mirrors)
    act = np.flatnonzero(state.tile_active)
    note('h2d')
    note('jit')
    ds = _expand_jit(state.device_tiles_pal()[jnp.asarray(
        act.astype(np.int32))])
    tile_of = np.repeat(act, 4)
    attrs_of = np.tile(_ATTR_ORDER, len(act))
    return ds, tile_of, attrs_of


_expand_jit = None


# -- stage 1: candidate marking -------------------------------------------

def _mark_queries_idx(state: EncoderState, k: int):
    """Marking query INDICES for keyframe k: the unique referenced tile
    ids + the cell->unique inverse (the query rows themselves gather on
    device from the resident tile tensor)."""
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    return np.unique(cell_tiles, return_inverse=True)


def _mark_queries(state: EncoderState, k: int):
    """Host-side marking queries for keyframe k: the unique referenced
    tiles' PalPixels rows."""
    uq_tiles, tile_inv = _mark_queries_idx(state, k)
    queries = state.tiles_pal[uq_tiles].reshape(len(uq_tiles), -1) \
        .astype(np.float32)
    return uq_tiles, tile_inv, queries


def _mark_from_knn(state: EncoderState, k: int, idxs, keep, tile_inv,
                   n_uq: int, n_ds: int, pal_mask: np.ndarray | None):
    """Pure host set logic turning the 8-NN results into the bool[P, 4A]
    used-combo indicator (UseOne, main.pas:3802-3853). `keep` is the
    consecutive-equal-error skip mask (main.pas:3832-3837), computed on
    device by knn.nearest_k_keepmask so the f32 errors never download."""
    cfg = state.config
    s, e = state.keyframes[k]
    cell_pals = state.tm_pal[s:e + 1].ravel()

    # unique (pal, tile) pairs drive the marking; the whole per-palette
    # loop is pure set logic, so it vectorizes exactly: scatter the kept
    # k-NN hits into a per-palette indicator, then expand across palettes
    # (SLOW: any palette; MEDIUM: the pal_mask boolean matmul)
    pair_ids = cell_pals.astype(np.int64) * n_uq + tile_inv
    uq_pairs = np.unique(pair_ids)
    pair_pal = (uq_pairs // n_uq).astype(np.int64)
    pair_tile_row = (uq_pairs % n_uq).astype(np.int64)

    marked_q = np.zeros((cfg.palette_count, n_ds), bool)
    km = keep[pair_tile_row]                         # [n_pairs, 8]
    marked_q[np.repeat(pair_pal, km.sum(1)),
             idxs[pair_tile_row][km]] = True
    if cfg.ft_quality == FTQuality.FAST:
        used = marked_q
    elif cfg.ft_quality == FTQuality.SLOW:
        used = np.broadcast_to(marked_q.any(0),
                               marked_q.shape).copy()
    else:  # MEDIUM: used[j] = any marking palette q with centroid near j
        used = (pal_mask.astype(np.float32)
                @ marked_q.astype(np.float32)) > 0
    return used


def mark_candidates(state: EncoderState, k: int, ds, tile_of, attrs_of,
                    pal_mask: np.ndarray | None):
    """Stage 1 for ONE keyframe: bool[P, 4A] used-combo indicator.

    run_frame_tiling batches the k-NN across every keyframe instead
    (same per-row results — rows are independent); this entry point
    serves tools/tests that study one keyframe."""
    uq_tiles, tile_inv, queries = _mark_queries(state, k)
    from ..parallel.mesh_pipeline import mesh_ok, nearest_k_sharded
    if mesh_ok(state.mesh):
        idxs, errs = nearest_k_sharded(state.mesh, queries, ds, k=8)
        keep = knn.keep_from_errs(errs)
    else:
        idxs, keep = knn.nearest_k_keepmask(queries, ds, k=8)
    return _mark_from_knn(state, k, idxs, keep, tile_inv, len(uq_tiles),
                          len(ds), pal_mask)


def palette_similarity_mask(state: EncoderState, k: int) -> np.ndarray:
    """[P,P] bool: pal_mask[j,q] = centroid j close enough to q
    (BuildPaletteCorrTriangle + APalTol test, main.pas:3843-3847)."""
    cfg = state.config
    c = state.palette_centroids[k].astype(np.float64)
    d = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    finite = np.nan_to_num(d, nan=0.0, posinf=0.0)
    highest = finite.max() if finite.size else 0.0
    return d < cfg.ft_palette_tol * highest


# -- stage 2: candidate-combo PsyV features -------------------------------

def candidate_features(state: EncoderState, k: int, used, tile_of, attrs_of,
                       chunk: int = 262144, tiles_pal_dev=None):
    """Stage 2 for ONE keyframe (wrapper over the multi-keyframe batch):
    PsyV features of every used (pal, tile, mirror) combo. Returns
    (feats [C,192] device, pal_idx [C] i32, tile_idx [C] i32, attrs [C])."""
    per_kf = candidate_features_multi(state, [k], [used], tile_of,
                                      attrs_of, chunk=chunk,
                                      tiles_pal_dev=tiles_pal_dev)
    return per_kf[0]


def candidate_features_multi(state: EncoderState, kfs: list[int],
                             used_list, tile_of, attrs_of,
                             chunk: int | None = None, tiles_pal_dev=None):
    """Stage 2 batched across keyframes: ONE feature pass over every
    keyframe's candidate combos (palettes stacked [len(kfs)*P, S, 3] so a
    combo's palette row is kf_slot*P + pal).

    The mirror-dedup decision (signed-permutation expansion vs direct
    pixels; the two differ in f32 low bits) stays PER KEYFRAME — same
    gate as the per-keyframe schedule, so streams are byte-identical to
    it — but all keyframes taking the same path batch into one pass.

    Mirror dedup (wavelet basis): a mirrored tile's features are an EXACT
    signed column permutation of the unmirrored ones
    (features.mirror_coeff_perms), so the expensive palette-LUT +
    colorspace + basis matmul runs once per (kf, pal, tile) and the
    mirror variants expand with static permutations, then un-sort back to
    the per-keyframe (pal, dentry) candidate order so exact-distance ties
    resolve identically to the direct path.

    Returns [per kf in `kfs` order]: (feats [C_k,192] device slice,
    pal_idx [C_k] i32, tile_idx [C_k] i32, attrs [C_k])."""
    import functools
    import os
    import jax
    import jax.numpy as jnp
    cfg = state.config
    n_p = cfg.palette_count
    if chunk is None:
        chunk = int(os.environ.get('TILER_FT_CHUNK', 262144))

    from ..parallel.mesh_pipeline import (mesh_ok, per_device_rows,
                                          replicate)
    par = mesh_ok(state.mesh)
    tiles_pal_d = state.device_tiles_pal() if tiles_pal_dev is None \
        else tiles_pal_dev  # uploaded once per encode by run_frame_tiling
    note('h2d')
    pals_d = jnp.asarray(
        np.ascontiguousarray(state.palettes_rgb[np.asarray(kfs)])
        .reshape(len(kfs) * n_p, -1, 3))
    if par:
        tiles_pal_d = replicate(state.mesh, tiles_pal_d)
        pals_d = replicate(state.mesh, pals_d)
    global _chunk_feats_jit
    if _chunk_feats_jit is None:
        _chunk_feats_jit = functools.partial(
            jax.jit, static_argnames=('code_mult', 'gamma_value',
                                      'use_wavelets'))(_chunk_feats)
    chunk_feats = _chunk_feats_jit

    # single-int32 index packing: val = tile * code_mult + code where
    # code = pal_row*4 + h + 2v — HALF the per-chunk H2D bytes of the
    # old [2, n] matrix. Falls back to the
    # two-row form when the product could overflow int32 (very long
    # clips before GlobalTiling shrinks the tileset).
    code_mult = 4 * len(kfs) * n_p
    packable = int(state.n_tiles) * code_mult < 2 ** 31

    # device combo enumeration (round 5): the combo index stream CAN
    # derive on device from the used-combo BITMASK (~32x fewer upload
    # bytes); jnp.nonzero's ascending flat order IS np.nonzero(used)'s
    # row-major order, so candidate order — and stage-3 tie resolution —
    # is unchanged. OPT-IN (TILER_FT_ENUM=1): it trades a 16.8M-element
    # device unpack+nonzero per keyframe for ~17 MB of index uploads, and
    # has not been measured on the GPU.
    enum_path = not par and os.environ.get('TILER_FT_ENUM') == '1'
    tile_of_dev = attrs_of_dev = None
    if enum_path:
        note('h2d', 2)
        tile_of_dev = jnp.asarray(tile_of.astype(np.int32))
        attrs_of_dev = jnp.asarray(attrs_of.astype(np.int32))

    def slot_feats_device_enum(slot: int, used) -> None:
        global _enum_jit, _chunk_feats_enum_jit
        if _enum_jit is None:
            _enum_jit = functools.partial(
                jax.jit, static_argnames=('size',))(_enum_used)
        if _chunk_feats_enum_jit is None:
            _chunk_feats_enum_jit = functools.partial(
                jax.jit, static_argnames=('n_pad', 'n_p', 'n_ds',
                                          'gamma_value',
                                          'use_wavelets'))(
                _chunk_feats_enum)
        c_k = int(used.sum())
        if c_k == 0:
            from ..constants import TILE_DCT_SIZE
            feats_by_slot[slot] = jnp.zeros((0, TILE_DCT_SIZE),
                                            jnp.float32)
            return
        n_ds_l = used.shape[1]
        c_pad = features.pad_pow2(c_k)
        note('h2d')
        note('jit')
        combo = _enum_jit(jnp.asarray(np.packbits(used.reshape(-1))),
                          c_pad)
        parts = []
        for lo in range(0, c_k, chunk):
            hi = min(c_k, lo + chunk)
            n_pad = features.pad_pow2(hi - lo)
            note('jit')
            parts.append(_chunk_feats_enum_jit(
                tiles_pal_d, pals_d, combo, tile_of_dev, attrs_of_dev,
                jnp.int32(lo), jnp.int32(slot), n_pad, n_p, n_ds_l,
                _ft_gamma(cfg), cfg.use_wavelets)[:hi - lo])
        if len(parts) > 1:
            note('eager')
        feats_by_slot[slot] = jnp.concatenate(parts) \
            if len(parts) > 1 else parts[0]

    def base_feats(b_tiles, b_pals, b_hm, b_vm):
        # candidate features stay ON DEVICE: only the packed int32 index
        # vector goes up per chunk, nothing comes down (the 1-NN scan
        # consumes them in place). Mesh path: combo rows shard across
        # devices.
        n = len(b_tiles)
        parts = []
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            n_pad = features.pad_pow2(hi - lo)
            code = (b_pals[lo:hi].astype(np.int64) * 4
                    + b_hm[lo:hi] + 2 * b_vm[lo:hi])
            if packable:
                packed = np.zeros(n_pad, np.int32)
                packed[:hi - lo] = (b_tiles[lo:hi].astype(np.int64)
                                    * code_mult + code)
                mult = code_mult
            else:
                packed = np.zeros((2, n_pad), np.int32)
                packed[0, :hi - lo] = b_tiles[lo:hi]
                packed[1, :hi - lo] = code
                mult = 0
            note('h2d')
            note('jit')
            if par:
                res = per_device_rows(
                    state.mesh,
                    lambda pk, tp, pal, mult=mult: chunk_feats(
                        tp, pal, pk, mult, _ft_gamma(cfg),
                        cfg.use_wavelets),
                    packed, tiles_pal_d, pals_d, axis=packed.ndim - 1)
            else:
                res = chunk_feats(
                    tiles_pal_d, pals_d, jnp.asarray(packed), mult,
                    _ft_gamma(cfg), cfg.use_wavelets)
            parts.append(res[:hi - lo])
        if len(parts) > 1:
            note('eager')
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    # per-keyframe combo lists + the per-keyframe path gate
    pp = features.mirror_coeff_perms(cfg.use_wavelets)
    combos = []          # (kf_slot, pal_idx, dentry, tiles, attrs, perm?)
    for slot, used in enumerate(used_list):
        pal_idx, dentry = np.nonzero(used)
        c = len(pal_idx)
        tiles = tile_of[dentry]
        attrs = attrs_of[dentry]
        pair_ids = pal_idx.astype(np.int64) * int(state.n_tiles) + tiles
        n_uq = len(np.unique(pair_ids))
        state.metrics.setdefault('ft_pair_dedup', []).append(
            round(c / max(n_uq, 1), 3))
        # perm expansion only pays when the pair dedup at least HALVES
        # the base feature work: below that, the expansion's extra
        # dispatches, un-sort gather and grouped copies cost more than
        # the base rows they save. The gate has not been measured again
        # on the GPU.
        use_perm = pp is not None and n_uq <= 0.5 * c \
            and os.environ.get('TILER_FT_NO_PERM') != '1'
        combos.append((slot, pal_idx, dentry, tiles, attrs, use_perm))

    feats_by_slot: dict = {}

    def run_group(group, use_perm: bool):
        """One batched pass over the kf slots taking the same path."""
        slot_ids = np.concatenate(
            [np.full(len(g[1]), g[0], np.int64) for g in group])
        pal_idx = np.concatenate([g[1] for g in group])
        tiles = np.concatenate([g[3] for g in group])
        attrs = np.concatenate([g[4] for g in group])
        gpal = slot_ids * n_p + pal_idx          # row into stacked pals_d
        if use_perm:
            perm4, sign4 = pp
            pair_ids = gpal * int(state.n_tiles) + tiles
            uq, inv = np.unique(pair_ids, return_inverse=True)
            base = base_feats((uq % state.n_tiles).astype(np.int32),
                              (uq // state.n_tiles).astype(np.int32),
                              np.zeros(len(uq), bool),
                              np.zeros(len(uq), bool))
            if par:
                # the mirror expansion gathers arbitrary base rows;
                # replicate once (all-gather) instead of per-gather
                # collectives
                base = replicate(state.mesh, base)
            # bucket the base length: the expand jit specializes on the
            # (base, packed) shapes, an exact len(uq) would recompile
            # per keyframe batch
            b_pad = features.pad_pow2(len(uq))
            if b_pad != base.shape[0]:
                note('eager')
                base = jnp.pad(base, ((0, b_pad - base.shape[0]), (0, 0)))
            # per-attr groups with STATIC column permutations: a static
            # permutation is a plain copy and the order-restoring ROW
            # gather is coalesced, where a fused per-row take_along_axis
            # gathers element by element. Combos sort by attr, expand per group, then
            # un-sort so exact-distance ties resolve in the original
            # (pal, dentry) candidate order (the stage-3 argmin
            # tie-breaks on candidate index; the direct path and the
            # reference's mirror walk use this order).
            order = np.argsort(attrs, kind='stable')
            ginv = inv[order]
            global _mirror_expand_jit
            if _mirror_expand_jit is None:
                _mirror_expand_jit = jax.jit(
                    _mirror_expand_one, static_argnames=('attr',))
            perm_d, sign_d = jnp.asarray(perm4), jnp.asarray(sign4)
            bounds = np.searchsorted(attrs[order], np.arange(5))
            parts = []
            for a in range(4):
                lo, hi = int(bounds[a]), int(bounds[a + 1])
                if hi == lo:
                    continue
                n_pad = features.pad_pow2(hi - lo)  # bucketed compiles
                seg = np.zeros(n_pad, np.int32)
                seg[:hi - lo] = ginv[lo:hi]
                note('h2d')
                note('jit')
                parts.append(_mirror_expand_jit(base, jnp.asarray(seg),
                                                perm_d, sign_d, a)
                             [:hi - lo])
            note('eager')
            feats = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
            inv_order = np.empty_like(order)
            inv_order[order] = np.arange(len(order))
            note('h2d')
            note('eager')
            feats = feats[jnp.asarray(inv_order.astype(np.int32))]
            del base, parts  # free the base rows + group copies
        else:
            feats = base_feats(tiles, gpal.astype(np.int64),
                               (attrs & 1).astype(bool),
                               (attrs & 2).astype(bool))
        # slice the group result back into per-kf-slot buffers (a
        # single-keyframe group IS its result — no copy; device slices
        # materialize new buffers, which doubled peak HBM on huge
        # single-keyframe candidate sets)
        if len(group) == 1:
            feats_by_slot[group[0][0]] = feats
            return
        off = 0
        for g in group:
            c_k = len(g[1])
            note('eager')
            feats_by_slot[g[0]] = feats[off:off + c_k]
            off += c_k

    perm_group = [g for g in combos if g[5]]
    direct_group = [g for g in combos if not g[5]]
    if perm_group:
        run_group(perm_group, True)
    if direct_group:
        if enum_path:
            for g in direct_group:
                slot_feats_device_enum(g[0], used_list[g[0]])
        else:
            run_group(direct_group, False)

    return [(feats_by_slot[slot], pal_idx.astype(np.int32),
             tiles.astype(np.int32), attrs)
            for slot, pal_idx, _, tiles, attrs, _ in combos]


def _mirror_expand_one(base, ginv, perm4, sign4, attr: int):
    """One mirror-attr group: row gather from the base (pal,tile)
    features + static column permutation + sign."""
    return base[ginv][:, perm4[attr]] * sign4[attr][None, :]


def _chunk_feats(tp_all, pal_all, packed, code_mult: int, gamma_value,
                 use_wavelets):
    """Candidate-combo PsyV features via device gathers (module-level so
    the jit cache persists across keyframes and encodes). packed is the
    single-int32 form [N] (tile*code_mult + code) when code_mult > 0,
    else [2,N] i32: row 0 = tile index, row 1 = code; code =
    palette_row*4 + hmir + 2*vmir."""
    if code_mult > 0:
        tidx = packed // code_mult
        code = packed % code_mult
    else:
        tidx = packed[0]
        code = packed[1]
    tp = tp_all[tidx]
    pals = pal_all[code >> 2]
    t = features.mirror_tiles(tp, (code & 1).astype(bool),
                              (code & 2).astype(bool))
    cpn = features.pal_tiles_to_cpn(t, pals, gamma_value, False)
    return features.psyv_from_cpn(cpn, use_wavelets=use_wavelets)


def _enum_used(bits_u8, size: int):
    """Unpack the used-combo bitmask (np.packbits MSB-first) and
    enumerate set positions in ascending flat order — exactly
    np.nonzero(used)'s row-major candidate order (stage-3 tie
    resolution depends on it). Trailing packbits padding bits are zero
    and never enumerate."""
    import jax.numpy as jnp
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    flat = ((bits_u8[:, None] >> shifts[None, :]) & 1).reshape(-1)
    return jnp.nonzero(flat, size=size, fill_value=0)[0].astype(jnp.int32)


def _chunk_feats_enum(tp_all, pal_all, combo, tile_of, attrs_of, lo,
                      slot, n_pad: int, n_p: int, n_ds: int, gamma_value,
                      use_wavelets):
    """_chunk_feats with the per-chunk combo indices sliced from the
    device-enumerated list (dynamic start, static length) and decoded
    through the device tile/attr maps — no per-chunk index upload. The
    caller guarantees lo + n_pad <= len(combo) (the enumeration pads to
    a chunk-covering power of two), so the dynamic slice never clamps."""
    import jax
    d = jax.lax.dynamic_slice_in_dim(combo, lo, n_pad)
    pal = d // n_ds
    dentry = d % n_ds
    tile = tile_of[dentry]
    attr = attrs_of[dentry]
    code = (slot * n_p + pal) * 4 + (attr & 1) + (attr & 2)
    tp = tp_all[tile]
    pals = pal_all[code >> 2]
    t = features.mirror_tiles(tp, (code & 1).astype(bool),
                              (code & 2).astype(bool))
    cpn = features.pal_tiles_to_cpn(t, pals, gamma_value, False)
    return features.psyv_from_cpn(cpn, use_wavelets=use_wavelets)


_chunk_feats_jit = None
_mirror_expand_jit = None
_mark_gather_jit = None
_enum_jit = None
_chunk_feats_enum_jit = None


# -- stage 3: fused query features + streaming 1-NN -----------------------

@functools.partial(jax.jit, static_argnames=('qchunk', 'gamma_value',
                                             'use_wavelets'))
def _assign_step(rows, src_all, cands, qchunk: int, gamma_value,
                 use_wavelets):
    """Fused stage 3 for a WHOLE keyframe in ONE dispatch: a lax.scan over
    query chunks, each chunk gathering its source tiles on device,
    computing PsyV features and running the exact 1-NN (knn.argmin_1nn).
    Only the int32 row vector goes up; only [Q] idx/err come down (at the
    caller's single end-of-step sync)."""
    def body(carry, r):
        q = features.psyv_features_rgb(src_all[r], gamma_value=gamma_value,
                                       use_wavelets=use_wavelets)
        return carry, knn.argmin_1nn(q, cands)

    _, (idx, err) = jax.lax.scan(body, None, rows.reshape(-1, qchunk))
    return idx.reshape(-1), err.reshape(-1)


def _changed_mask(frames_rgb: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[F,H,W,3] u8 -> bool [F, th*tw]: cell differs from the same cell
    one frame earlier (frame 0 all-True). Queries whose source tile
    bytes equal the previous frame's are EXACT duplicates for stage 3
    (the candidate set is per-keyframe), so their 1-NN result forward-
    fills instead of recomputing — assign cost scales with motion.

    Host numpy on purpose: a device version would cost one XLA compile
    per distinct clip shape; this is a single memory-bound pass."""
    f = frames_rgb.shape[0]
    x = frames_rgb[:, :th * TILE_W, :tw * TILE_W] \
        .reshape(f, th, TILE_W, tw, TILE_W, 3)
    eq = (x[1:] == x[:-1]).all(axis=(2, 4, 5))       # [F-1, th, tw]
    out = np.ones((f, th * tw), bool)
    out[1:] = ~eq.reshape(f - 1, th * tw)
    return out


def _queue_assign(state: EncoderState, k: int, feats, kf_plan, dev_parts,
                  ch_all, src_all, par: bool) -> None:
    """Queue keyframe k's fused stage-3 dispatch (no sync): lay out the
    candidates, build the query row vector (with the temporal dedup),
    dispatch, and append the device result slices + the host fill plan."""
    import os

    import jax.numpy as jnp
    cfg = state.config
    s, e = state.keyframes[k]

    note('eager')
    cands = knn.pad_candidates(feats)
    if par:
        from ..parallel.mesh_pipeline import replicate
        cands = replicate(state.mesh, cands)

    base = s * state.tilemap_size
    cells = state.tilemap_size
    f_kf = e - s + 1
    n_q = f_kf * cells
    # temporal query dedup: cells byte-identical to the previous frame
    # forward-fill their 1-NN result (exact; see _changed_mask). The
    # fill must not cross a keyframe boundary — candidate sets and
    # palettes change — so the first frame is all-changed.
    ch = ch_all[s:e + 1].copy()
    ch[0, :] = True
    if os.environ.get('TILER_NO_QDEDUP') == '1':
        ch[:] = True  # cross-check switch: recompute every cell
    changed = np.flatnonzero(ch.ravel())
    dense = len(changed) > 0.98 * n_q  # host fill shortcut only
    n_run = n_q if dense else len(changed)
    qp = features.pad_pow2(n_run)
    rows = np.full(qp, base + (0 if dense else changed[0]), np.int32)
    if dense:
        rows[:n_run] = base + np.arange(n_run, dtype=np.int32)
    else:
        rows[:n_run] = base + changed
    note('h2d')
    note('jit')
    if par:
        from ..parallel.mesh_pipeline import per_device_rows
        qloc = min(16384, qp // state.mesh.devices.size)
        idx, err = per_device_rows(
            state.mesh,
            lambda r, src, c: _assign_step(r, src, c, qloc, _ft_gamma(cfg),
                                           cfg.use_wavelets),
            rows, src_all, cands)
    else:
        idx, err = _assign_step(
            jnp.asarray(rows), src_all, cands, min(16384, qp),
            _ft_gamma(cfg), cfg.use_wavelets)
    dev_parts.append((idx[:n_run], err[:n_run]))
    kf_plan.append((dense, ch, changed, n_run))


def _row_budget() -> int:
    """Stage-2/3 group size in candidate rows. A group's candidate
    features (192 f32 = 768 B a row, x2 transient for the padded copy)
    stay resident until its flush, so a group may take an eighth of the
    device's memory; the rest holds the mirror-expansion base and the
    encode's other resident tensors."""
    from ..utils.memory import device_bytes_limit
    return max(1, device_bytes_limit() // 8 // (2 * 768))


def run_frame_tiling(state: EncoderState) -> EncoderState:
    import time

    import jax.numpy as jnp
    from ..parallel.mesh_pipeline import (mesh_ok, nearest_k_sharded,
                                          replicate)
    par = mesh_ok(state.mesh)
    cfg = state.config
    n_kf = len(state.keyframes)
    phases = {'mark': 0.0, 'cand_feats': 0.0, 'assign': 0.0}
    t0 = time.perf_counter()
    ds, tile_of, attrs_of = build_global_dataset(state)
    jax.block_until_ready(ds)
    phases['dataset'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    tiles_pal_dev = state.device_tiles_pal()
    if par:
        # one broadcast per encode; candidate_features' replicate()
        # then no-ops on the already-replicated tensor every keyframe
        tiles_pal_dev = replicate(state.mesh, tiles_pal_dev)
    jax.block_until_ready(tiles_pal_dev)
    phases['upload'] = round(time.perf_counter() - t0, 3)
    # load computes the mask once for the motion-aware upload (keyframe
    # starts forced True there — a no-op for this consumer, which forces
    # each keyframe's first row itself); states resumed from checkpoints
    # may lack it
    ch_all = state.changed_mask if state.changed_mask is not None else \
        _changed_mask(state.frames_rgb, state.tilemap_h, state.tilemap_w)

    # ---- stage 1, ALL keyframes: one k-NN pass over the shared global
    # dataset (per-query results are independent, so batching across
    # keyframes changes nothing but the dispatch count) ----
    t0 = time.perf_counter()
    mark_q = [_mark_queries_idx(state, k) for k in range(n_kf)]
    if par:
        all_q = np.concatenate(
            [state.tiles_pal[m[0]].reshape(len(m[0]), -1)
             .astype(np.float32) for m in mark_q])
        idxs_all, errs_all = nearest_k_sharded(state.mesh, all_q, ds,
                                               k=8, q_chunk=16384)
        keep_all = knn.keep_from_errs(errs_all)
        del errs_all, all_q
    else:
        # queries gather ON DEVICE from the resident tile tensor — only
        # the int32 index vector goes up (the [Q,64] f32 host queries
        # were stage-1's dominant H2D bytes). 16384-query chunks over
        # the 64-dim dataset: [16k, 8k] f32 distance tiles (512 MB, the
        # stage-3 scan's bound); the keep mask replaces the f32 errors
        # on the wire (device-side consecutive-equal skip)
        n_q = sum(len(m[0]) for m in mark_q)
        qcap = -(-n_q // 16384) * 16384
        q_idx = np.zeros(qcap, np.int32)
        q_idx[:n_q] = np.concatenate([m[0] for m in mark_q])
        global _mark_gather_jit
        if _mark_gather_jit is None:
            _mark_gather_jit = jax.jit(
                lambda tp, ix: tp[ix].reshape(ix.shape[0], -1)
                .astype(jnp.float32))
        note('h2d')
        note('jit')
        qdev = _mark_gather_jit(tiles_pal_dev, jnp.asarray(q_idx))
        idxs_all, keep_all = knn.nearest_k_keepmask(
            qdev, ds, k=8, q_chunk=16384, n_rows=n_q)
    used_list = []
    off = 0
    for k in range(n_kf):
        uq_tiles, tile_inv = mark_q[k]
        n_uq = len(uq_tiles)
        pal_mask = palette_similarity_mask(state, k) \
            if cfg.ft_quality == FTQuality.MEDIUM else None
        used_list.append(_mark_from_knn(
            state, k, idxs_all[off:off + n_uq], keep_all[off:off + n_uq],
            tile_inv, n_uq, len(ds), pal_mask))
        off += n_uq
    del mark_q, idxs_all, keep_all
    phases['mark'] = round(time.perf_counter() - t0, 3)

    # ---- stages 2+3, batched across keyframes in HBM-bounded groups:
    # a group's candidate features + queued assign inputs stay resident
    # until its flush sync, so peak device memory is O(group), not
    # O(clip). The row estimate is exact (= the marking indicator sum),
    # known before any feature work. A single keyframe always forms a
    # valid group regardless of size (same bound as the per-keyframe
    # schedule this replaced). ----
    est_rows = [int(u.sum()) for u in used_list]
    row_budget = _row_budget()
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_rows = 0
    for k in range(n_kf):
        if cur and cur_rows + est_rows[k] > row_budget:
            groups.append(cur)
            cur, cur_rows = [], 0
        cur.append(k)
        cur_rows += est_rows[k]
    if cur:
        groups.append(cur)

    t_feats = t_assign = 0.0
    src_all = state.device_source_tiles()
    if par:
        src_all = replicate(state.mesh, src_all)

    q_total = q_changed = 0
    knn_sizes = []
    per_kf_host = {}  # kf -> (cand_pal, cand_tile, cand_attrs)
    kf_plan = []      # per kf: (dense, ch, changed, n_run)
    dev_parts = []    # per kf: (idx_dev, err_dev) device slices
    for gi, group in enumerate(groups):
        t0 = time.perf_counter()
        per_kf = candidate_features_multi(
            state, group, [used_list[k] for k in group], tile_of,
            attrs_of, tiles_pal_dev=tiles_pal_dev)
        knn_sizes.extend(int(f.shape[0]) for f, _, _, _ in per_kf)
        jax.block_until_ready(per_kf[-1][0])
        t_feats += time.perf_counter() - t0
        t0 = time.perf_counter()
        for slot, k in enumerate(group):
            s, e = state.keyframes[k]
            feats, cand_pal, cand_tile, cand_attrs = per_kf[slot]
            per_kf_host[k] = (cand_pal, cand_tile, cand_attrs)
            _queue_assign(state, k, feats, kf_plan, dev_parts,
                          ch_all, src_all, par)
            per_kf[slot] = None
        if gi + 1 < len(groups):
            # flush: a tiny D2H forces every queued dispatch to finish,
            # freeing this group's device buffers before the next
            # group's features materialize
            note('d2h')
            np.asarray(dev_parts[-1][1][-1:])
        t_assign += time.perf_counter() - t0
    phases['cand_feats'] = round(t_feats, 3)
    del per_kf
    t0 = time.perf_counter()

    # single sync for the whole step
    if n_kf > 1:
        note('eager', 2)
        all_idx = np.asarray(jnp.concatenate([p[0] for p in dev_parts]))
        all_err = np.asarray(jnp.concatenate([p[1] for p in dev_parts]))
    else:
        all_idx = np.asarray(dev_parts[0][0])
        all_err = np.asarray(dev_parts[0][1])
    note('d2h', 2)

    # ---- host: forward fills + tilemap writes ----
    residual = 0.0
    off = 0
    for k in range(n_kf):
        s, e = state.keyframes[k]
        cand_pal, cand_tile, cand_attrs = per_kf_host[k]
        dense, ch, changed, n_run = kf_plan[k]
        q_total += (e - s + 1) * state.tilemap_size
        q_changed += len(changed)
        run_idx = all_idx[off:off + n_run]
        run_err = all_err[off:off + n_run]
        off += n_run
        cells = state.tilemap_size
        f_kf = e - s + 1
        if dense:
            best_idx, best_err = run_idx, run_err
        else:
            # forward fill: each cell takes the result computed at its
            # most recent changed frame (frame 0 is always changed)
            last = np.maximum.accumulate(
                np.where(ch, np.arange(f_kf)[:, None], -1), axis=0)
            changed_pos = np.cumsum(ch.ravel()) - 1
            src_flat = (last * cells
                        + np.arange(cells)[None, :]).ravel()
            fill = changed_pos[src_flat]
            best_idx = run_idx[fill]
            best_err = run_err[fill]
        shape = (f_kf, state.tilemap_h, state.tilemap_w)
        state.tm_tile[s:e + 1] = cand_tile[best_idx].reshape(shape)
        state.tm_pal[s:e + 1] = cand_pal[best_idx].reshape(shape)
        state.tm_h[s:e + 1] = (cand_attrs[best_idx] & 1).astype(bool) \
            .reshape(shape)
        state.tm_v[s:e + 1] = (cand_attrs[best_idx] & 2).astype(bool) \
            .reshape(shape)
        residual += float(best_err.sum())
    phases['assign'] = round(t_assign + time.perf_counter() - t0, 3)

    state.metrics['ft_residual_err'] = residual
    state.metrics['ft_knn_sizes'] = knn_sizes
    state.metrics['ft_q_changed_frac'] = round(
        q_changed / max(q_total, 1), 4)
    state.metrics['ft_phases'] = {k: round(v, 3) for k, v in phases.items()}
    return state
