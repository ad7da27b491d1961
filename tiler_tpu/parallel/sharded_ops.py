"""Data-parallel sharded versions of the encoder's heavy device ops.

These shard the batch (tiles / cells) across every device of a mesh and
keep model-side state (centroids, candidate sets) replicated — the P1/P2
frame- and keyframe-parallelism of the reference's thread pool
(SURVEY.md §2.4) mapped onto devices, with psum allreduce where the
reference shared memory:

  - sharded_psyv_features : pure DP, no communication
  - sharded_kmeans        : local assign + psum(sums, counts) allreduce per
                            iteration (the yakmo-replacement at scale)
  - sharded_nearest_1     : queries sharded, candidates replicated

All ops accept any mesh from parallel.mesh.make_mesh and degrade
gracefully to a single device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import features
from ..ops.numerics import stream_precision
from .mesh import ROWS as _AXES


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def sharded_psyv_features(mesh: Mesh, tiles_rgb: np.ndarray,
                          gamma_value=None, use_lab=False,
                          use_wavelets=False, q_weighting=False):
    """[N,8,8,3] u8 -> [N,192] f32 with the batch sharded across devices."""
    n = len(tiles_rgb)
    n_dev = mesh.devices.size
    n_pad = _pad_to(max(n, n_dev), n_dev * 256)
    tp = np.concatenate(
        [tiles_rgb,
         np.zeros((n_pad - n, 8, 8, 3), np.uint8)]) if n_pad != n \
        else tiles_rgb
    sh = NamedSharding(mesh, P(_AXES))
    x = jax.device_put(tp, sh)

    @functools.partial(jax.jit, out_shardings=sh)
    def run(t):
        cpn = features.rgb_tiles_to_cpn(t, gamma_value, use_lab)
        return features.psyv_from_cpn(cpn, use_wavelets=use_wavelets,
                                      q_weighting=q_weighting)

    return np.asarray(run(x))[:n]


def sharded_kmeans(mesh: Mesh, feats: np.ndarray, k: int,
                   max_iters: int = 100, seed: int = 0x42381337):
    """Distributed Lloyd's k-means: features sharded over all devices,
    centroid statistics allreduced with psum each iteration.

    Returns (labels [N] i32, centroids [k,D] f32)."""
    n, d = feats.shape
    n_dev = mesh.devices.size
    n_pad = _pad_to(max(n, n_dev * 8), n_dev * 8)
    fp = np.concatenate([feats, np.zeros((n_pad - n, d), feats.dtype)]) \
        if n_pad != n else feats
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    data_sh = NamedSharding(mesh, P(_AXES))
    x = jax.device_put(np.asarray(fp, np.float32), data_sh)
    v = jax.device_put(valid, data_sh)

    # deterministic k-means++ init on replicated data head (cheap): use the
    # single-device init from ops.kmeans on a subsample for seeding
    from ..ops.kmeans import _plus_plus_init
    sub = np.asarray(fp[:min(n_pad, 16384)], np.float32)
    cents0 = np.asarray(_plus_plus_init(jnp.asarray(sub), k,
                                        jax.random.PRNGKey(seed)))

    def step(x_loc, v_loc, cents):
        c2 = jnp.sum(cents * cents, axis=1)
        dist = (jnp.sum(x_loc * x_loc, 1)[:, None] + c2[None, :]
                - 2.0 * jnp.matmul(x_loc, cents.T,
                                   precision=stream_precision()))
        lab = jnp.argmin(dist, axis=1)
        w = v_loc.astype(jnp.float32)
        onehot = jax.nn.one_hot(lab, k, dtype=jnp.float32) * w[:, None]
        sums = jax.lax.psum(
            jnp.matmul(onehot.T, x_loc, precision=jax.lax.Precision.HIGHEST),
            _AXES)
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), _AXES)
        new_cents = jnp.where(counts[:, None] > 0,
                              sums / jnp.maximum(counts, 1.0)[:, None],
                              cents)
        moved = jax.lax.psum(
            jnp.sum(jnp.abs(new_cents - cents)), _AXES) / mesh.devices.size
        return lab.astype(jnp.int32), new_cents, moved

    sharded_step = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(_AXES), P(_AXES), P(None, None)),
        out_specs=(P(_AXES), P(None, None), P()),
        check_vma=False))

    cents = jnp.asarray(cents0)
    labels = None
    for _ in range(max_iters):
        labels, new_cents, moved = sharded_step(x, v, cents)
        if float(moved) == 0.0:
            cents = new_cents
            break
        cents = new_cents
    return np.asarray(labels)[:n], np.asarray(cents)


def sharded_kmodes(mesh: Mesh, x: np.ndarray, k: int, start_point: int,
                   n_modalities: int, max_iters: int = 100):
    """Distributed KModes: points sharded across every device of the mesh,
    per-(cluster, attribute) category counts allreduced with psum each
    iteration — the SURVEY §5.8(b) centroid allreduce, applied to the
    GlobalTiling clusterer (reference: single-host thread pool,
    kmodes.pas:845-915).

    BIT-IDENTICAL to the single-device solver (ops.kmodes.kmodes) for any
    power-of-two device count:
      - farthest-first init (kmodes.pas:698-776) runs as a cross-shard
        first-argmax (contiguous shards + first-local-argmax == global
        jnp.argmax tie-break) with the winning row broadcast by psum;
      - category counts are exact small integers, so the f32 psum is
        reduction-order-independent;
      - the convergence cost is the exact mixed-radix int32 triple from
        ops.kmodes._cost_triple (digit sums psum exactly).

    Returns (labels [n] int32, centroids [k, A] uint8).
    """
    from ..ops.kmodes import _next_pow2

    devices = mesh.devices.reshape(-1)
    n_dev = devices.size
    assert n_dev & (n_dev - 1) == 0, 'device count must be a power of two'
    flat_mesh = Mesh(devices, ('km',))

    n, a = x.shape
    assert 0 < k <= n
    n_pad = _next_pow2(max(n, 8, n_dev))
    k_pad = _next_pow2(max(k, 2))
    xp = np.zeros((n_pad, a), np.uint8)
    xp[:n] = x
    valid_n = np.zeros(n_pad, bool)
    valid_n[:n] = True
    valid_k = np.zeros(k_pad, bool)
    valid_k[:k] = True
    n_loc = n_pad // n_dev
    fn = _kmodes_solver(flat_mesh, n_loc, a, k_pad, n_modalities,
                        max_iters)

    data_sh = NamedSharding(flat_mesh, P('km'))

    def run(sp: int):
        labels, cents, cost = fn(jax.device_put(xp, data_sh),
                                 jax.device_put(valid_n, data_sh),
                                 jnp.asarray(valid_k), jnp.int32(sp))
        return labels, cents, tuple(int(v) for v in np.asarray(cost))

    if start_point >= 0:
        labels, cents, _cost = run(start_point)
    else:
        # golden-ratio multi-restart, lowest cost wins, first on ties
        # (kmodes.pas:949-966, 1046-1053) — identical selection to the
        # single-device paths so N-host stays bit-equal to 1-host
        from ..ops.kmodes import golden_ratio_starts
        best = None
        for sp in golden_ratio_starts(n, -start_point):
            labels_i, cents_i, cost = run(sp)
            if best is None or cost < best[0]:
                best = (cost, labels_i, cents_i)
        _, labels, cents = best
    return np.asarray(labels)[:n], np.asarray(cents)[:k]


@functools.lru_cache(maxsize=128)
def _kmodes_solver(flat_mesh: Mesh, n_loc: int, a: int, k_pad: int,
                   n_modalities: int, max_iters: int):
    """Builds (and caches) the jitted shard_mapped KModes solver for one
    padded shape bucket. The per-call closure in round-2's version made
    jax.jit recompile for EVERY bin of a GlobalTiling solve — 16+
    compiles per encode was why the mesh-KModes path measured 4.6x
    slower than the vmapped batch solver; bins share a handful of pow2
    shape buckets, so the cache brings distributed GT solves down to a
    few compiles total."""
    from ..constants import DISSIM_SUB_MATCHING_BITS
    from ..ops.kmodes import (_EXACT_F32_INT, _cost_less, make_dissim_fn,
                              _normalize_cost_triple)
    ax = 'km'
    # 0/1 weights: the segment_sum counts below (scatter-add atomics on a
    # GPU) and their psum are exact float32 integers, so order-independent,
    # while the whole bin stays below 2^24 points
    if n_loc * flat_mesh.devices.size >= _EXACT_F32_INT:
        raise ValueError('KModes bin too large for exact float32 counts')

    def solver(x_loc, v_loc, valid_k, start_point):
        my = jax.lax.axis_index(ax)
        xi = x_loc.astype(jnp.int32)
        w = v_loc.astype(jnp.float32)
        base = my * n_loc
        local_pos = jnp.arange(n_loc)

        def dis_to(p):
            ham = jnp.sum((xi != p[None, :]).astype(jnp.int32), axis=1)
            l1 = jnp.sum(jnp.abs(xi - p[None, :]), axis=1)
            return (ham << DISSIM_SUB_MATCHING_BITS) + l1

        def fetch_row(g):
            """x row at GLOBAL index g, replicated (psum broadcast)."""
            local = jnp.clip(g - base, 0, n_loc - 1)
            owner = (g >= base) & (g < base + n_loc)
            row = jnp.where(owner, xi[local], 0)
            return jax.lax.psum(row, ax)

        def global_first_argmax(val_loc):
            """(max value, global index of its FIRST occurrence) — matches
            jnp.argmax over the concatenated array because shards are
            contiguous and ordered."""
            li = jnp.argmax(val_loc)
            vals = jax.lax.all_gather(val_loc[li], ax)         # [D]
            gidx = jax.lax.all_gather(base + li, ax)           # [D]
            best = jnp.argmax(vals)
            return vals[best], gidx[best]

        def mask_global_idx(mind, g):
            local = g - base
            return jnp.where(local_pos == local, -1, mind)

        # farthest-first init (global argmax each step)
        start_row = fetch_row(start_point)
        cents = jnp.zeros((k_pad, a), jnp.int32)
        cents = cents.at[0].set(start_row)
        mind = jnp.where(v_loc, dis_to(start_row), -1)
        mind = mask_global_idx(mind, start_point)

        def ff_body(i, carry):
            cents, mind = carry
            _, g = global_first_argmax(mind)
            row = fetch_row(g)
            cents = cents.at[i].set(row)
            mind = jnp.where(v_loc, jnp.minimum(mind, dis_to(row)), -1)
            mind = mask_global_idx(mind, g)
            return cents, mind

        cents, _ = jax.lax.fori_loop(1, k_pad, ff_body, (cents, mind))
        cents = cents.astype(jnp.uint8)
        dissim_to, _ex = make_dissim_fn(x_loc, valid_k, n_modalities)

        def assign(cents):
            d = dissim_to(cents)
            lab = jnp.argmin(d, axis=1).astype(jnp.int32)
            md = jnp.where(v_loc, jnp.min(d, axis=1), 0).astype(jnp.int32)
            digits = (jax.lax.psum(jnp.sum(md >> 12), ax),
                      jax.lax.psum(jnp.sum((md >> 6) & 63), ax),
                      jax.lax.psum(jnp.sum(md & 63), ax))
            return lab, _normalize_cost_triple(digits)

        def update(cents, labels):
            ids = ((labels[:, None] * a + jnp.arange(a)[None, :])
                   * n_modalities + x_loc.astype(jnp.int32))
            weights = jnp.broadcast_to(w[:, None], (n_loc, a)).ravel()
            counts = jax.lax.psum(
                jax.ops.segment_sum(weights, ids.ravel(),
                                    num_segments=k_pad * a * n_modalities),
                ax).reshape(k_pad, a, n_modalities)
            new_c = jnp.argmax(counts, axis=-1).astype(jnp.uint8)
            members = jax.lax.psum(
                jax.ops.segment_sum(w, labels, num_segments=k_pad), ax)
            empty = (members == 0) & valid_k
            d_own = jnp.sum(
                jnp.abs(x_loc.astype(jnp.int32) -
                        jnp.take(new_c, labels, axis=0).astype(jnp.int32)),
                axis=1)
            d_own = jnp.where(v_loc, d_own, -1)
            _, g = global_first_argmax(d_own)
            worst_row = fetch_row(g).astype(jnp.uint8)
            new_c = jnp.where(empty[:, None], worst_row[None, :], new_c)
            return new_c

        labels, cost = assign(cents)

        def cond(carry):
            _, _, prev_cost, cost, moves, it = carry
            improved = jnp.logical_and(_cost_less(cost, prev_cost),
                                       moves > 0)
            return jnp.logical_and(improved, it < max_iters)

        def body(carry):
            cents, labels, _, cost, _, it = carry
            cents = update(cents, labels)
            new_labels, new_cost = assign(cents)
            moves = jax.lax.psum(
                jnp.sum(jnp.where(v_loc, new_labels != labels,
                                  False).astype(jnp.int32)), ax)
            return (cents, new_labels, cost, new_cost, moves, it + 1)

        inf_cost = (jnp.int32(2**30), jnp.int32(63), jnp.int32(63))
        init = (cents, labels, inf_cost, cost, jnp.int32(1), jnp.int32(0))
        cents, labels, _, cost, _, _ = jax.lax.while_loop(cond, body, init)
        cents = update(cents, labels)
        labels, cost = assign(cents)
        return labels, cents, jnp.stack(cost)

    return jax.jit(jax.shard_map(
        solver, mesh=flat_mesh,
        in_specs=(P(ax), P(ax), P(None), P()),
        out_specs=(P(ax), P(None, None), P(None)),
        check_vma=False))


def sharded_nearest_1(mesh: Mesh, queries: np.ndarray,
                      candidates: np.ndarray):
    """Queries sharded across devices, candidates replicated; exact 1-NN
    (the same knn.argmin_1nn program on each shard)."""
    from ..ops import knn
    n = len(queries)
    n_dev = mesh.devices.size
    n_pad = _pad_to(max(n, n_dev), n_dev * 8)
    qp = np.concatenate(
        [queries, np.zeros((n_pad - n, queries.shape[1]),
                           queries.dtype)]) if n_pad != n else queries

    q = jax.device_put(np.asarray(qp, np.float32),
                       NamedSharding(mesh, P(_AXES)))
    c = jax.device_put(knn.pad_candidates(candidates),
                       NamedSharding(mesh, P(None, None)))
    fn = jax.jit(jax.shard_map(
        knn.argmin_1nn,
        mesh=mesh, in_specs=(P(_AXES), P(None, None)),
        out_specs=(P(_AXES), P(_AXES)), check_vma=False))
    idx, err = fn(q, c)
    return np.asarray(idx)[:n], np.asarray(err)[:n]


# -- distributed exact tile dedup (MakeUnique across the mesh) ------------

_unique_count_cache: dict = {}
_unique_dedup_cache: dict = {}


def _hash_words(words):
    """Cheap 32-bit mix of the [L,16] u32 row words (Knuth multiplicative
    fold + final avalanche). Only bucket BALANCE depends on quality; the
    dedup is exact regardless — byte-equal rows always hash equal."""
    h = words[:, 0]
    for i in range(1, 16):
        h = (h * jnp.uint32(2654435761)) ^ words[:, i]
    h = h ^ (h >> 16)
    h = h * jnp.uint32(2246822519)
    return h ^ (h >> 13)


def _rows_to_words(tiles_u8, act_loc, n_tiles: int):
    """Gather [l] active indices -> ([l,16] u32 big-endian words,
    [l] bool sentinel mask) via the SHARED word packing
    (pipeline.unique.tile_words — byte-compatibility with the
    single-device dedup kernel is what keeps mesh streams identical).
    Sentinel rows (index == n_tiles, the padding) get all-0xFFFFFFFF
    words so they form their own group (or join a real all-0xFF group,
    where the min-index winner is the real row — the host filters
    sentinel pairs out either way)."""
    from ..pipeline.unique import tile_words
    words = tile_words(tiles_u8, act_loc)
    sent = act_loc >= n_tiles
    return jnp.where(sent[:, None], jnp.uint32(0xFFFFFFFF), words), sent


def _get_unique_count_fn(flat_mesh: Mesh, n_tiles: int):
    key = (flat_mesh, n_tiles)
    fn = _unique_count_cache.get(key)
    if fn is not None:
        return fn
    _unique_count_cache.clear()
    d = flat_mesh.devices.size

    def local(tiles_rep, act_loc):
        words, _ = _rows_to_words(tiles_rep, act_loc, n_tiles)
        dst = _hash_words(words) & jnp.uint32(d - 1)
        return jnp.bincount(dst.astype(jnp.int32), length=d)[None, :]

    fn = jax.jit(jax.shard_map(
        local, mesh=flat_mesh, in_specs=(P(), P('dedup')),
        out_specs=P('dedup')))
    _unique_count_cache[key] = fn
    return fn


def _get_unique_dedup_fn(flat_mesh: Mesh, n_tiles: int, cap: int):
    key = (flat_mesh, n_tiles, cap)
    fn = _unique_dedup_cache.get(key)
    if fn is not None:
        return fn
    _unique_dedup_cache.clear()
    d = flat_mesh.devices.size

    def local(tiles_rep, act_loc):
        l = act_loc.shape[0]
        words, _ = _rows_to_words(tiles_rep, act_loc, n_tiles)
        dst = (_hash_words(words) & jnp.uint32(d - 1)).astype(jnp.int32)

        # pack rows into the [d, cap] send buffer: stable-sort by dst,
        # slot = rank within its dst run
        order_dst, perm = jax.lax.sort(
            (dst, jnp.arange(l, dtype=jnp.int32)), num_keys=1,
            is_stable=True)
        counts = jnp.bincount(dst, length=d)
        starts = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]
             .astype(jnp.int32)])
        slot = jnp.arange(l, dtype=jnp.int32) - starts[order_dst]
        send_w = jnp.full((d, cap, 16), jnp.uint32(0xFFFFFFFF))
        send_i = jnp.full((d, cap), jnp.int32(n_tiles))
        send_w = send_w.at[order_dst, slot].set(jnp.take(words, perm,
                                                         axis=0))
        send_i = send_i.at[order_dst, slot].set(jnp.take(act_loc, perm))

        # the shuffle: every byte-equal row lands on the shard its hash
        # owns, so the local dedup below is globally exact
        rw = jax.lax.all_to_all(send_w, 'dedup', split_axis=0,
                                concat_axis=0).reshape(d * cap, 16)
        ri = jax.lax.all_to_all(send_i, 'dedup', split_axis=0,
                                concat_axis=0).reshape(d * cap)

        # local dedup through THE shared core (pipeline.unique
        # .dedupe_words — byte-equal rows all landed on this shard, so
        # the per-shard dedup is globally exact)
        from ..pipeline.unique import dedupe_words
        si, winner = dedupe_words(rw, ri)
        return si[None], winner[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=flat_mesh, in_specs=(P(), P('dedup')),
        out_specs=P('dedup')))
    _unique_dedup_cache[key] = fn
    return fn


def sharded_unique(mesh: Mesh, tiles_pal_dev, act: np.ndarray,
                   n_tiles: int):
    """Exact distributed MakeUnique over the mesh: rows hash-partition
    across devices (one all_to_all), each shard dedups its partition
    with the same radix kernel as the single-device path
    (pipeline.unique._unique_fwd_dev_jit), so per-shard work is
    ~A/D log A/D instead of A log A — the reference's tile-chunk
    MakeUnique fan-out (main.pas:933, SURVEY P4) as a real multi-device
    program.

    Returns host (sidx, winner) pairs over the padded rows; entries with
    sidx >= n_tiles are padding. CANONICAL output: winner = min tile
    index of each byte-equal group, independent of the partitioning —
    streams stay byte-identical to the single-device encode by
    construction (asserted at 1/2/8 devices by test)."""
    devices = mesh.devices.reshape(-1)
    d = devices.size
    flat_mesh = Mesh(devices, ('dedup',))
    a_pad = 1 << max(8, (int(len(act)) - 1).bit_length())
    a_pad = _pad_to(a_pad, d)
    act_p = np.full(a_pad, n_tiles, np.int32)
    act_p[:len(act)] = act

    tiles_rep = jax.device_put(
        tiles_pal_dev, NamedSharding(flat_mesh, P(None, None, None)))
    act_d = jax.device_put(act_p, NamedSharding(flat_mesh, P('dedup')))

    counts = np.asarray(_get_unique_count_fn(flat_mesh, n_tiles)(
        tiles_rep, act_d))                       # [d, d] per-src counts
    # per-(src,dst) capacity bucket (pow2): static shape for the
    # all_to_all; a handful of compiles per encode at most
    cap = 1 << max(4, int(counts.max() - 1).bit_length())
    sidx, winner = _get_unique_dedup_fn(flat_mesh, n_tiles, cap)(
        tiles_rep, act_d)
    return np.asarray(sidx).reshape(-1), np.asarray(winner).reshape(-1)
