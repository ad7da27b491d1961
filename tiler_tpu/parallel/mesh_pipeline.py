"""Production frame-axis mesh execution for the encoder pipeline.

This wires the device mesh (parallel.mesh.make_mesh) into the REAL
pipeline steps. The axis being replaced is the reference's per-frame
thread fan-out (the reference's main.pas:972, 1095): frames/cells of a
GOP spread across devices.

Design rules (all four matter for the byte-identity guarantee):
  * only embarrassingly-parallel stages shard — queries/rows split
    across devices, model state (candidate features, tile tensors,
    palettes) replicated. Per-row math is unchanged, so results are
    bit-identical to the single-device encode (asserted by
    tests/test_parallel.py::test_mesh_encode_byte_identical).
  * cross-row couplings stay on one logical device: the dither plan
    dedup (a global sort), the dither k-means (per_device_rows' comment
    says why it does not shard), and the GTM writer.
  * each shard runs the SAME jitted program as the single-device path
    (shard_map, not GSPMD auto-partitioning), so per-device behavior is
    predictable.
  * the float-heavy FrameTiling stages 2 and 3 go one step further and
    run the 1-device executable itself per device (per_device_rows).

Sharded here:
  stage 3 assign  (frame_tiling: PsyV features + streaming 1-NN; the
                   dominant phase — one dispatch per keyframe and device)
  stage 2 feats   (frame_tiling candidate features, per device)
  stage 1 mark    (frame_tiling 8-NN marking)
  Knoll dither    (plan counts + rank selection halves)
  smooth          (cell axis: fused features + frame-chain scan)
  KModes solves   (global_tiling via sharded_ops.sharded_kmodes when
                   config.mesh_kmodes, bit-identical at 1/2/8 devices)
  MakeUnique      (hash-partitioned exact dedup, one
                   all_to_all + per-shard radix dedup —
                   sharded_ops.sharded_unique; canonical winners keep
                   streams byte-identical)
  GT signatures   (row-parallel signature build,
                   signatures_sharded below)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P



def mesh_ok(mesh) -> bool:
    """Usable production mesh: >1 device, power-of-two size (row padding
    is pow2-bucketed, so any pow2 device count divides every batch)."""
    if mesh is None or not isinstance(mesh, Mesh):
        return False
    n = mesh.devices.size
    return n > 1 and (n & (n - 1)) == 0


def replicate(mesh: Mesh, arr):
    """Place an array fully replicated on every mesh device (no-op when
    it already carries that sharding — callers replicate hot tensors
    once per encode and pass them down)."""
    ndim = arr.ndim if hasattr(arr, 'ndim') else np.asarray(arr).ndim
    sh = NamedSharding(mesh, P(*(None,) * ndim))
    if getattr(arr, 'sharding', None) == sh:
        return arr
    return jax.device_put(arr, sh)


def shard_rows(mesh: Mesh, arr):
    """Shard the leading axis across every device of the mesh."""
    ndim = arr.ndim if hasattr(arr, 'ndim') else np.asarray(arr).ndim
    spec = P(mesh.axis_names, *(None,) * (ndim - 1))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _evict_other_meshes(cache: dict, mesh: Mesh) -> None:
    """Single-mesh cache policy: encodes use one mesh at a time, so when
    a new mesh shows up the compiled programs (and any replicated device
    buffers) of previous meshes are dead weight — drop them instead of
    holding them for the process lifetime."""
    stale = [k for k in cache
             if (k[0] if isinstance(k, tuple) else k) is not mesh]
    for k in stale:
        del cache[k]


# -- stages 2 and 3: the single-device programs, once per device --------
# A shard_map program is compiled (fused, autotuned) as a program of its
# own, and on the GPU its float32 results can differ from the 1-device
# program's in the last bits, which moves nearest-neighbour winners.
# So the float-heavy FrameTiling stages run the 1-device jitted function
# itself on each device's contiguous slice of the rows: every device
# runs the executable the 1-device encode runs (at a smaller row count).


def local_copy(arr, device):
    """arr's buffer on `device`: the shard already there when arr is
    replicated over a mesh that holds it, else a copy."""
    for shard in getattr(arr, 'addressable_shards', ()):
        if shard.device == device and shard.data.shape == arr.shape:
            return shard.data
    return jax.device_put(arr, device)


def per_device_rows(mesh: Mesh, fn, rows, *args, axis: int = 0):
    """fn(rows_slice, *args) on every device of the mesh, rows split
    along `axis` into equal contiguous slices (the length must divide by
    the device count); args are given to each device whole (replicated
    arrays are used in place). Returns fn's outputs as arrays sharded
    along their first axis over the mesh, rows in the original order."""
    devs = list(mesh.devices.ravel())
    parts = np.split(np.asarray(rows), len(devs), axis=axis)
    outs = [fn(jax.device_put(part, d), *(local_copy(a, d) for a in args))
            for part, d in zip(parts, devs)]
    sh = NamedSharding(mesh, P(mesh.axis_names))

    def join(parts):
        shape = (parts[0].shape[0] * len(parts),) + parts[0].shape[1:]
        return jax.make_array_from_single_device_arrays(shape, sh, parts)

    return jax.tree.map(lambda *parts: join(list(parts)), *outs)


# -- Knoll dither: plan counts + per-pixel rank selection -----------------
# The global color dedup (a device-wide sort) stays on one device; the
# row-parallel halves — plan counts per unique color and the per-tile
# Bayer rank selection, where the dither FLOPs are — shard across the
# mesh with the plan table replicated. Same per-row programs as
# ops.dither, so the dithered bytes are identical.

_knoll_cache: dict = {}


def _get_knoll_fns(mesh: Mesh):
    fns = _knoll_cache.get(mesh)
    if fns is not None:
        return fns
    _evict_other_meshes(_knoll_cache, mesh)
    ax = mesh.axis_names

    def counts_local(uniq_chunk, pals):
        from ..ops.dither import _counts_from_keys
        return _counts_from_keys(uniq_chunk, pals)

    def assign_local(counts_rep, inv2d, keys, pals):
        from ..ops.dither import _assign_counts
        return _assign_counts(counts_rep, inv2d.reshape(-1), keys, pals)

    counts_fn = jax.jit(jax.shard_map(
        counts_local, mesh=mesh,
        in_specs=(P(ax), P(None, None, None)),
        out_specs=P(ax, None), check_vma=False))
    assign_fn = jax.jit(jax.shard_map(
        assign_local, mesh=mesh,
        in_specs=(P(None, None), P(ax, None), P(ax, None),
                  P(None, None, None)),
        out_specs=P(ax, None), check_vma=False))
    fns = (counts_fn, assign_fn)
    _knoll_cache[mesh] = fns
    return fns


def knoll_counts_sharded(mesh: Mesh, uniq_chunk, pals_rep):
    """ops.dither._counts_from_keys with the unique colors sharded."""
    counts_fn, _ = _get_knoll_fns(mesh)
    return counts_fn(shard_rows(mesh, uniq_chunk), pals_rep)


def knoll_assign_sharded(mesh: Mesh, counts_rep, inv, keys, pals_rep):
    """ops.dither._assign_counts with the tile rows sharded; the plan
    table replicated. inv is [n,64] here (sharded by tile row, flattened
    per shard to match the single-device call)."""
    _, assign_fn = _get_knoll_fns(mesh)
    return assign_fn(counts_rep, shard_rows(mesh, inv),
                     shard_rows(mesh, keys), pals_rep)


# -- smooth: fused cell features + frame-chain scan, cells sharded --------
# The frame chain is sequential, but every CELL's chain is independent —
# the reference's per-row thread fan-out (main.pas:1366) becomes the cell
# axis sharded across the mesh, with the reduced tileset + the keyframe's
# palettes replicated. Same per-cell program as pipeline.smooth, so the
# smoothed tilemap (and the stream) is byte-identical.

_smooth_cache: dict = {}


def _get_smooth_fn(mesh: Mesh, strength: float):
    key = (mesh, strength)
    fn = _smooth_cache.get(key)
    if fn is not None:
        return fn
    _evict_other_meshes(_smooth_cache, mesh)
    ax = mesh.axis_names

    def local(tp_all, pals, tile, pal, hm, vm):
        from ..pipeline.smooth import (_cell_features, _pack_stm,
                                       _smooth_chain)
        f, c_loc = tile.shape
        feats = _cell_features(
            tp_all, pals, tile.reshape(-1), pal.reshape(-1),
            hm.reshape(-1), vm.reshape(-1)).reshape(f, c_loc, -1)
        return _pack_stm(_smooth_chain(feats, tile, pal, hm, vm,
                                       strength))

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None, None), P(None, None, None),
                  P(None, ax), P(None, ax), P(None, ax), P(None, ax)),
        out_specs=(P(None, ax),) * 3, check_vma=False))
    _smooth_cache[key] = fn
    return fn


def smooth_sharded(mesh: Mesh, tp_rep, palettes_k: np.ndarray,
                   tile: np.ndarray, pal: np.ndarray, hm: np.ndarray,
                   vm: np.ndarray, strength: float):
    """One keyframe's fused smooth with the CELL axis sharded.

    tile/pal/hm/vm: [F, C] host arrays; the cell axis pads up to a
    device-count multiple (padded cells compute independently and the
    caller slices them off). Returns the packed stm tuple (tile i32,
    pal u8, flags u8), each [F, C_pad] device-sharded."""
    n_dev = mesh.devices.size
    f, c = tile.shape
    cp = -(-c // n_dev) * n_dev

    def pad(a):
        if cp == c:
            return a
        return np.concatenate(
            [a, np.zeros((f, cp - c), a.dtype)], axis=1)

    sh = NamedSharding(mesh, P(None, mesh.axis_names))
    fn = _get_smooth_fn(mesh, strength)
    pals_rep = jax.device_put(palettes_k,
                              NamedSharding(mesh, P(None, None, None)))
    return fn(tp_rep, pals_rep,
              jax.device_put(pad(tile), sh), jax.device_put(pad(pal), sh),
              jax.device_put(pad(hm), sh), jax.device_put(pad(vm), sh))


# -- stage 1: 8-NN marking ------------------------------------------------

_topk_cache: dict = {}


def _get_topk_fn(mesh: Mesh, k: int):
    key = (mesh, k)
    fn = _topk_cache.get(key)
    if fn is not None:
        return fn
    _evict_other_meshes(_topk_cache, mesh)
    ax = mesh.axis_names

    def local(q_loc, cands):
        from ..ops.knn import _scan_topk
        return _scan_topk(q_loc, cands, k)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(ax, None), P(None, None)),
        out_specs=(P(ax, None), P(ax, None)), check_vma=False))
    _topk_cache[key] = fn
    return fn


_cands_rep_cache: dict = {}


def nearest_k_sharded(mesh: Mesh, queries: np.ndarray, candidates,
                      k: int, q_chunk: int = 8192):
    """ops.knn.nearest_k with each query chunk sharded across the mesh;
    candidates replicated. Bit-identical per query to the single-device
    scan (same _scan_topk program on a smaller batch)."""
    from ..ops.knn import _pad_pow2, _pad_rows, pad_candidates
    q_all = np.asarray(queries, np.float32)
    n_q = len(q_all)
    # one-entry cache: FrameTiling marks every keyframe against the SAME
    # global dataset — rebuilding + re-broadcasting it per keyframe would
    # repeat the broadcast (id() key is safe here: the cache also
    # holds a reference, so the id cannot be recycled while cached)
    ckey = (mesh, id(candidates))
    if _cands_rep_cache.get('key') != ckey:
        _cands_rep_cache.clear()
        _cands_rep_cache['key'] = ckey
        _cands_rep_cache['src'] = candidates
        _cands_rep_cache['rep'] = replicate(
            mesh, pad_candidates(candidates))
    cands = _cands_rep_cache['rep']
    fn = _get_topk_fn(mesh, k)
    sh = NamedSharding(mesh, P(mesh.axis_names, None))
    # queue all chunks, download once (ops.knn._download_parts semantics)
    from ..ops.knn import _download_parts
    parts = []
    for qs in range(0, n_q, q_chunk):
        qe = min(n_q, qs + q_chunk)
        qp = _pad_pow2(qe - qs)
        q = jax.device_put(_pad_rows(q_all[qs:qe], qp), sh)
        idx, err = fn(q, cands)
        parts.append((idx[:qe - qs], err[:qe - qs]))
    return _download_parts(parts, empty_shape=(0, k))


# -- GlobalTiling signature build (row-parallel) --------------------------

_sigs_cache: dict = {}


def signatures_sharded(mesh: Mesh, tiles_pal_dev, act_p: np.ndarray,
                       palette_size: int):
    """global_tiling's per-tile [80]-byte KModes signature build with the
    active-row axis sharded across the mesh (the tiles tensor is
    replicated). Pure integer math — per-row values are identical to the
    single-device kernel, so everything downstream (and the stream) is
    unchanged. Returns (sigs [A,80] u8 sharded, sums [A] i32 host-bound
    device array), matching _signatures_device_jit's contract."""
    key = (mesh, palette_size)
    fn = _sigs_cache.get(key)
    if fn is None:
        _evict_other_meshes(_sigs_cache, mesh)

        def local(tiles_rep, act_loc):
            from ..constants import KMODES_ZONE_COUNT
            flat = tiles_rep[act_loc].reshape(act_loc.shape[0], 64) \
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

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P(mesh.axis_names)),
            out_specs=(P(mesh.axis_names), P(mesh.axis_names))))
        _sigs_cache[key] = fn

    act_d = jax.device_put(
        act_p, NamedSharding(mesh, P(mesh.axis_names)))
    tiles_rep = replicate(mesh, tiles_pal_dev)
    return fn(tiles_rep, act_d)
