"""KModes clustering over uint8 tile signatures — the kmodes.pas replacement.

Reference: TKModes.ComputeKModes (/root/reference/kmodes.pas:917-1060) with
farthest-first init (kmodes.pas:698-776), the Hamming<<11 + L1 dissimilarity
(kmodes.pas:239-250, SSE3 at kmodes.pas:316-596), per-attribute category
frequency centroid updates (kmodes.pas:778-806), and empty-cluster repair.

Design: the dissimilarity between [n,80] points and [k,80] centroids is
one exact one-hot matmul (make_dissim_fn; a broadcast compare+abs-diff
reduction for large modality counts); assignment is an argmin over k; the centroid update is a one-hot count
einsum + argmax over modalities. The reference's ONLINE per-point moves
(centroids updated after every reassignment) become batch Lloyd-style
iterations — a deliberate redesign: same objective, deterministic, and the
whole solver is a single jitted while_loop. Shapes are padded to buckets so
recompiles are bounded; masked lanes never win an argmin/argmax.

Divergences from the reference (documented):
- batch instead of online updates (different trajectory, similar cost);
- empty clusters are re-seeded with the point farthest from its assigned
  centroid instead of a random member of the biggest cluster;
- argmin tie-breaks take the first minimum (the SSE3 scan takes the last).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DISSIM_SUB_MATCHING_BITS

_EXACT_F32_INT = 1 << 24   # float32 holds every integer below this

_BIG = jnp.int32(2**30)


def _cost_triple(per_point_dissim):
    """Exact total dissimilarity as a mixed-radix (hi, mid, lo) int32 triple.

    Per-point dissims are < 2^18 (80<<11 + 80*255), so float accumulation
    would round for large bins; summing the three 6-bit digit planes
    separately keeps every partial sum exact in int32 up to n = 2^24
    points, and the normalized triple compares lexicographically. This is
    also what makes the cost SHARD-INVARIANT: int32 psums of digit sums
    are exact regardless of reduction order (parallel.sharded_ops relies
    on this for N-device == 1-device convergence decisions)."""
    d = per_point_dissim.astype(jnp.int32)
    a = jnp.sum(d & 63)
    b = jnp.sum((d >> 6) & 63)
    c = jnp.sum(d >> 12)
    return _normalize_cost_triple((c, b, a))


def _normalize_cost_triple(t):
    c, b, a = t
    b = b + (a >> 6)
    a = a & 63
    c = c + (b >> 6)
    b = b & 63
    return c, b, a


def _cost_less(x, y):
    """Lexicographic x < y over normalized cost triples."""
    cx, bx, ax = x
    cy, by, ay = y
    return (cx < cy) | ((cx == cy) & ((bx < by) | ((bx == by) & (ax < ay))))


def dissim_matrix(x, c):
    """[n,A] uint8 points vs [k,A] uint8 centroids -> [n,k] int32
    (Hamming<<11 + L1, kmodes.pas:239-250). Broadcast form — fine for
    small n*k, materializes [n,k,A]."""
    xi = x.astype(jnp.int32)[:, None, :]
    ci = c.astype(jnp.int32)[None, :, :]
    ham = jnp.sum((xi != ci).astype(jnp.int32), axis=-1)
    l1 = jnp.sum(jnp.abs(xi - ci), axis=-1)
    return (ham << DISSIM_SUB_MATCHING_BITS) + l1


def dissim_matrix_matmul(x, c, n_modalities: int):
    """Same dissimilarity as two matmuls — no [n,k,A] intermediate.

    Hamming: matches = onehot(x) . onehot(c); ham = A - matches.
    L1 over small ints: |x-c| = #separating thresholds, so with
    gt[v,t] = (v > t): l1 = sum(gt_x) + sum(gt_c) - 2 gt_x . gt_c.
    All dot products are exact small integers in float32, at any matmul
    precision: the operands are 0/1, which TF32 and bf16 hold exactly, and
    every sum stays below 2^24. So no numerics-contract pin is needed.
    """
    n, a = x.shape
    k = c.shape[0]
    m = n_modalities
    ex = jax.nn.one_hot(x.astype(jnp.int32), m,
                        dtype=jnp.float32).reshape(n, a * m)
    ec = jax.nn.one_hot(c.astype(jnp.int32), m,
                        dtype=jnp.float32).reshape(k, a * m)
    matches = ex @ ec.T
    ham = jnp.float32(a) - matches
    thresholds = jnp.arange(m - 1)
    gx = (x.astype(jnp.int32)[:, :, None] > thresholds).astype(
        jnp.float32).reshape(n, a * (m - 1))
    gc = (c.astype(jnp.int32)[:, :, None] > thresholds).astype(
        jnp.float32).reshape(k, a * (m - 1))
    l1 = gx.sum(1)[:, None] + gc.sum(1)[None, :] - 2.0 * (gx @ gc.T)
    d = ham * (1 << DISSIM_SUB_MATCHING_BITS) + l1
    return d.astype(jnp.int32)


def _masked_dissim(x, c, valid_k, n_modalities=None):
    if n_modalities is not None and n_modalities <= 32:
        d = dissim_matrix_matmul(x, c, n_modalities)
    else:
        d = dissim_matrix(x, c)
    return jnp.where(valid_k[None, :], d, _BIG)


def make_dissim_fn(x, valid_k, n_modalities):
    """Returns (cents -> [n,k] masked dissim, point one-hots [n, A*M] or
    None) with the POINT-side encodings precomputed once (they are
    iteration-invariant; re-materializing them every while_loop step
    dominated the assign cost).

    The Hamming and L1 dots fuse into ONE matmul: with the point side
    X = [onehot(x), thresholds(x)] and the centroid side
    C = [onehot(c)<<BITS, 2*thresholds(c)],
      d = (A<<BITS) + sum(thr_x) + sum(thr_c) - X @ C.T
    (ham<<BITS = (A - onehot.onehot)<<BITS; l1 = sums - 2*thr.thr). One
    [n, A(2M-1)] @ [A(2M-1), k] dot replaces two
    (tools/kmodes_dissim_variants.py compares the forms).

    Encodings are bf16 — exact for the 0/1/2/2048 values used, and the
    products accumulate into f32 (preferred_element_type), so every dot is
    an exact integer (max 80<<11 + 2*1200 < 2^24) on any backend and needs
    no numerics-contract pin (ops.numerics). Falls back to the broadcast
    form for large modality counts."""
    if n_modalities is None or n_modalities > 32:
        return (lambda cents: _masked_dissim(x, cents, valid_k, None)), None

    n, a = x.shape
    m = n_modalities
    xi = x.astype(jnp.int32)
    ex = jax.nn.one_hot(xi, m, dtype=jnp.bfloat16).reshape(n, a * m)
    thresholds = jnp.arange(m - 1)
    gx = (xi[:, :, None] > thresholds).astype(
        jnp.bfloat16).reshape(n, a * (m - 1))
    x_cat = jnp.concatenate([ex, gx], axis=1)  # [n, A*(2M-1)]
    gx_sum = jnp.sum(gx.astype(jnp.float32), axis=1)
    bits = DISSIM_SUB_MATCHING_BITS

    def dissim(cents):
        ci = cents.astype(jnp.int32)
        ec = jax.nn.one_hot(ci, m, dtype=jnp.bfloat16).reshape(
            cents.shape[0], a * m) * jnp.bfloat16(1 << bits)
        gc = (ci[:, :, None] > thresholds).astype(
            jnp.bfloat16).reshape(cents.shape[0], a * (m - 1)) \
            * jnp.bfloat16(2)
        c_cat = jnp.concatenate([ec, gc], axis=1)
        dot = jnp.dot(x_cat, c_cat.T, preferred_element_type=jnp.float32)
        gc_sum = jnp.sum(gc.astype(jnp.float32), axis=1) * 0.5
        d = (jnp.float32(a << bits) + gx_sum[:, None] + gc_sum[None, :]
             - dot).astype(jnp.int32)
        return jnp.where(valid_k[None, :], d, _BIG)

    return dissim, x_cat[:, :a * m]


def _farthest_first(x, k_pad, valid_n, start_point):
    """Farthest-first centroids [k_pad, A] (kmodes.pas:698-776)."""
    n = x.shape[0]
    xi = x.astype(jnp.int32)

    def dis_to(p):
        d = jnp.sum((xi != p[None, :]).astype(jnp.int32), axis=1)
        l1 = jnp.sum(jnp.abs(xi - p[None, :].astype(jnp.int32)), axis=1)
        return (d << DISSIM_SUB_MATCHING_BITS) + l1

    cents = jnp.zeros((k_pad, x.shape[1]), jnp.uint8)
    cents = cents.at[0].set(x[start_point])
    mind = jnp.where(valid_n, dis_to(xi[start_point]), -1)
    mind = mind.at[start_point].set(-1)

    def body(i, carry):
        cents, mind = carry
        far = jnp.argmax(mind)
        cents = cents.at[i].set(x[far])
        nd = dis_to(xi[far])
        mind = jnp.where(valid_n, jnp.minimum(mind, nd), -1)
        mind = mind.at[far].set(-1)
        return cents, mind

    cents, _ = jax.lax.fori_loop(1, k_pad, body, (cents, mind))
    return cents


@functools.partial(jax.jit,
                   static_argnames=('k_pad', 'n_modalities', 'max_iters'))
def _kmodes_padded(x, valid_n, valid_k, start_point, k_pad: int,
                   n_modalities: int, max_iters: int):
    n, a = x.shape
    if n >= _EXACT_F32_INT:
        raise ValueError(f'KModes bin of {n} points: counts must stay '
                         'below 2^24 to sum exactly in float32')
    w = valid_n.astype(jnp.float32)

    cents = _farthest_first(x, k_pad, valid_n, start_point)
    dissim_to, ex_onehot = make_dissim_fn(x, valid_k, n_modalities)

    def assign(cents):
        d = dissim_to(cents)
        lab = jnp.argmin(d, axis=1).astype(jnp.int32)
        cost = _cost_triple(jnp.where(valid_n, jnp.min(d, axis=1), 0))
        return lab, cost

    def update(cents, labels):
        # per-(cluster, attribute) category frequencies. With the point
        # one-hots already resident (bf16 [n, A*M]) this is ONE matmul
        # lab1h.T @ ex — 0/1 operands, exact f32 integer counts at any
        # precision — instead of a scatter-add segment_sum.
        lab1h = ((labels[:, None] == jnp.arange(k_pad)[None, :]) &
                 valid_n[:, None])
        if ex_onehot is not None:
            counts = jnp.dot(lab1h.astype(jnp.bfloat16).T, ex_onehot,
                             preferred_element_type=jnp.float32
                             ).reshape(k_pad, a, n_modalities)
        else:
            ids = ((labels[:, None] * a + jnp.arange(a)[None, :])
                   * n_modalities + x.astype(jnp.int32))
            weights = jnp.broadcast_to(w[:, None], (n, a)).ravel()
            # 0/1 weights and n < 2^24: every partial sum is an exact
            # float32 integer, so the scatter-add's atomics (GPU) give
            # the same counts in any order
            counts = jax.ops.segment_sum(
                weights, ids.ravel(),
                num_segments=k_pad * a * n_modalities
            ).reshape(k_pad, a, n_modalities)
        new_c = jnp.argmax(counts, axis=-1).astype(jnp.uint8)  # [k,A]
        members = jnp.sum(lab1h.astype(jnp.float32), axis=0)
        empty = (members == 0) & valid_k
        # re-seed empty clusters with the currently worst-fit point
        d_own = jnp.sum(
            jnp.abs(x.astype(jnp.int32) -
                    jnp.take(new_c, labels, axis=0).astype(jnp.int32)),
            axis=1)
        d_own = jnp.where(valid_n, d_own, -1)
        worst = jnp.argmax(d_own)
        new_c = jnp.where(empty[:, None], x[worst][None, :], new_c)
        return new_c

    labels, cost = assign(cents)

    def cond(carry):
        _, _, _, prev_cost, cost, moves, it = carry
        improved = jnp.logical_and(_cost_less(cost, prev_cost), moves > 0)
        return jnp.logical_and(improved, it < max_iters)

    def body(carry):
        cents, labels, _, _, cost, _, it = carry
        cents = update(cents, labels)
        new_labels, new_cost = assign(cents)
        moves = jnp.sum(jnp.where(valid_n, new_labels != labels, False))
        return (cents, new_labels, labels, cost, new_cost, moves, it + 1)

    inf_cost = (jnp.int32(2**30), jnp.int32(63), jnp.int32(63))
    init = (cents, labels, labels, inf_cost,
            cost, jnp.int32(1), jnp.int32(0))
    cents, labels, _, _, cost, _, it = jax.lax.while_loop(cond, body, init)
    cents = update(cents, labels)
    labels, cost = assign(cents)
    return labels, cents, cost, it


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def golden_ratio_starts(n: int, num_init: int) -> list[int]:
    """Multi-restart starting points spread by repeated multiplication with
    n^(1/num_init) (kmodes.pas:949-966): strictly increasing, clamped to
    [0, n-1]. float32 accumulation mirrors the reference's Single math."""
    inv = np.float32(float(n) ** (1.0 / num_init))
    acc = np.float32(1.0)
    out: list[int] = []
    for i in range(num_init):
        sp = int(np.round(acc)) - 1  # round-half-even, like Pascal Round
        if i > 0 and sp <= out[-1]:
            sp = min(n - 1, out[-1] + 1)
        out.append(sp)
        acc = np.float32(acc * inv)
    return out


def _cost_key(cost_triple) -> tuple:
    """Host-side lexicographic key for a normalized (hi, mid, lo) cost."""
    c, b, a = (int(v) for v in cost_triple)
    return (c, b, a)


def kmodes(x: np.ndarray, k: int, start_point: int, n_modalities: int,
           max_iters: int = 100, return_cost: bool = False):
    """Cluster [n, 80] uint8 rows into k groups.

    start_point >= 0: farthest-first init from that row (the reference
    passes the bin's min-byte-sum row, main.pas:4300-4308).
    start_point < 0: |start_point| golden-ratio-spread restarts
    (kmodes.pas:949-966); the lowest-cost run wins, first on ties
    (kmodes.pas:1046-1053).

    Returns (labels [n] int32, centroids [k, 80] uint8[, cost tuple])."""
    n = x.shape[0]
    assert 0 < k <= n
    starts = ([start_point] if start_point >= 0
              else golden_ratio_starts(n, -start_point))
    n_pad = _next_pow2(max(n, 8))
    k_pad = _next_pow2(max(k, 2))
    xp = np.zeros((n_pad, x.shape[1]), np.uint8)
    xp[:n] = x
    valid_n = np.zeros(n_pad, bool)
    valid_n[:n] = True
    valid_k = np.zeros(k_pad, bool)
    valid_k[:k] = True
    best = None
    for s in starts:
        labels, cents, cost, _it = _kmodes_padded(
            jnp.asarray(xp), jnp.asarray(valid_n), jnp.asarray(valid_k),
            jnp.int32(s), k_pad, n_modalities, max_iters)
        key = _cost_key(cost)
        if best is None or key < best[0]:
            best = (key, labels, cents)
    _, labels, cents = best
    out = (np.asarray(labels)[:n], np.asarray(cents)[:k])
    return out + (best[0],) if return_cost else out


def kmodes_batch(bins_x: list[np.ndarray], bins_k: list[int],
                 bins_start: list[int], n_modalities: int,
                 max_iters: int = 100):
    """Solve MANY KModes problems in ONE vmapped device call.

    The reference fans per-palette-bin KModes across a thread pool
    (main.pas:4339); here every bin pads to a common (n_pad, k_pad) and a
    single vmapped while_loop solves them all — one compile, one dispatch
    for the whole GlobalTiling step.

    Negative bins_start[i] requests |start| golden-ratio restarts (one vmap
    lane each; lowest cost wins, first on ties — kmodes.pas:949-966,
    1046-1053).

    Returns list of (labels [n_i], centroids [k_i, A]).
    """
    b = len(bins_x)
    if b == 0:
        return []
    a = bins_x[0].shape[1]
    exp_x: list[np.ndarray] = []
    exp_k: list[int] = []
    exp_start: list[int] = []
    exp_owner: list[int] = []
    for i in range(b):
        starts = ([bins_start[i]] if bins_start[i] >= 0 else
                  golden_ratio_starts(len(bins_x[i]), -bins_start[i]))
        for s in starts:
            exp_x.append(bins_x[i])
            exp_k.append(bins_k[i])
            exp_start.append(s)
            exp_owner.append(i)

    results: list = [None] * len(exp_x)
    # pow2 size buckets: one compiled super-shape per bucket (see
    # _size_buckets)
    for bucket in _size_buckets(exp_x, exp_k, n_modalities=n_modalities,
                                attr_count=a):
        n_pad, k_pad, g, lane_chunks = bucket['shape']
        solver = jax.vmap(
            lambda x, valid_n, valid_k, s: _kmodes_padded(
                x, valid_n, valid_k, s, k_pad, n_modalities, max_iters)[:3])
        for lanes in lane_chunks:
            xs = np.zeros((g, n_pad, a), np.uint8)
            vn = np.zeros((g, n_pad), bool)
            vk = np.zeros((g, k_pad), bool)
            starts = np.zeros(g, np.int32)
            for j, i in enumerate(lanes):
                xs[j, :len(exp_x[i])] = exp_x[i]
                vn[j, :len(exp_x[i])] = True
                vk[j, :exp_k[i]] = True
                starts[j] = exp_start[i]
            labels, cents, cost = solver(jnp.asarray(xs), jnp.asarray(vn),
                                         jnp.asarray(vk),
                                         jnp.asarray(starts))
            labels = np.asarray(labels)
            cents = np.asarray(cents)
            cost = tuple(np.asarray(c) for c in cost)
            for j, i in enumerate(lanes):
                results[i] = (labels[j][:len(exp_x[i])],
                              cents[j][:exp_k[i]],
                              tuple(int(c[j]) for c in cost))

    out: list = [None] * b
    for i, owner in enumerate(exp_owner):
        lab, cen, cost = results[i]
        if out[owner] is None or cost < out[owner][2]:
            out[owner] = (lab, cen, cost)
    return [(lab, cen) for (lab, cen, _cost) in out]


def _winner_from(x, valid_n, labels, cents, k_pad: int):
    """Per-cluster winner: member with the smallest dissimilarity to its
    centroid, LAST index on ties (min_dissim_index_last semantics /
    kmodes.pas:598-612), computed on device via two segment passes."""
    xi = x.astype(jnp.int32)
    ci = jnp.take(cents, labels, axis=0).astype(jnp.int32)
    d = (jnp.sum((xi != ci).astype(jnp.int32), axis=1)
         << DISSIM_SUB_MATCHING_BITS) + jnp.sum(jnp.abs(xi - ci), axis=1)
    d = jnp.where(valid_n, d, _BIG)
    dmin = jax.ops.segment_min(d, labels, num_segments=k_pad)
    ismin = valid_n & (d == jnp.take(dmin, labels))
    iota = jnp.arange(x.shape[0], dtype=jnp.int32)
    return jax.ops.segment_max(jnp.where(ismin, iota, -1), labels,
                               num_segments=k_pad)


@functools.lru_cache(maxsize=32)
def _batch_gather_solver(k_pad: int, n_modalities: int, max_iters: int):
    """Cached jitted vmapped solve+winner (one compile per shape bucket).

    Labels return as int16 (k_pad <= 32767): halving the [g, n_pad] label
    download is free. The valid masks build on device from
    per-lane lengths (meta = [n_valid, k_valid, start] per lane) — the
    [g, n_pad] bool uploads were the step's dominant H2D bytes."""
    def one(sigs, idx, meta):
        n_pad = idx.shape[0]
        valid_n = jnp.arange(n_pad) < meta[0]
        valid_k = jnp.arange(k_pad) < meta[1]
        x = jnp.take(sigs, idx, axis=0)
        labels, cents, cost, it = _kmodes_padded(
            x, valid_n, valid_k, meta[2], k_pad, n_modalities, max_iters)
        return (labels.astype(jnp.int16), cents,
                _winner_from(x, valid_n, labels, cents, k_pad), it,
                jnp.stack(cost))

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


def kmodes_batch_gather(sigs_dev, bins_sel: list[np.ndarray],
                        bins_k: list[int], bins_start: list[int],
                        n_modalities: int, max_iters: int = 100,
                        iters_out: list | None = None,
                        need_cents: bool = True):
    """kmodes_batch against a DEVICE-resident signature matrix: bins are
    host index arrays into sigs_dev's rows; the per-group padded inputs
    are gathered on device (only int32 indices upload) and each solve also
    returns the per-cluster winner row, so the [A,80] signatures never
    reach the host.

    Negative bins_start[i] requests |start| golden-ratio restarts for that
    bin (kmodes.pas:949-966): each restart becomes an extra vmap LANE and
    the lowest-cost lane wins (first on ties, kmodes.pas:1046-1053).

    Returns list of (labels [n_i] np, cents [k_i,A] np, winner [k_i] np
    local member indices, -1 for empty clusters).

    ALL bins solve in ONE vmapped call at a single (n_pad, k_pad)
    super-shape: per-iteration compute is small (one [n,1280]x[1280,k]
    bf16 matmul per lane), but every distinct shape bucket costs a full
    XLA compile, so one shape per encode beats tighter padding.
    """
    b = len(bins_sel)
    if b == 0:
        return []
    # expand multi-restart bins into one lane per starting point
    exp_sel: list[np.ndarray] = []
    exp_k: list[int] = []
    exp_start: list[int] = []
    exp_owner: list[int] = []
    for i in range(b):
        starts = ([bins_start[i]] if bins_start[i] >= 0 else
                  golden_ratio_starts(len(bins_sel[i]), -bins_start[i]))
        for s in starts:
            exp_sel.append(bins_sel[i])
            exp_k.append(bins_k[i])
            exp_start.append(s)
            exp_owner.append(i)

    results: list = [None] * len(exp_sel)
    # two-phase: queue EVERY bucket's solve first, materialize afterwards —
    # a per-bucket np.asarray would serialize the device between buckets
    pending = []
    for bucket in _size_buckets(exp_sel, exp_k, n_modalities=n_modalities,
                                attr_count=int(sigs_dev.shape[1])):
        n_pad, k_pad, g, lane_chunks = bucket['shape']
        for lanes in lane_chunks:
            idxmat = np.zeros((g, n_pad), np.int32)
            meta = np.zeros((g, 3), np.int32)  # n_valid, k_valid, start
            for j, i in enumerate(lanes):
                sel = exp_sel[i]
                idxmat[j, :len(sel)] = sel
                meta[j] = (len(sel), exp_k[i], exp_start[i])
            from ..utils.dispatch import note
            note('h2d', 2)
            note('jit')
            labels, cents, winner, iters, costs = _batch_gather_solver(
                k_pad, n_modalities, max_iters)(
                    sigs_dev, jnp.asarray(idxmat), jnp.asarray(meta))
            pending.append((lanes, labels, cents, winner, iters, costs))
    # batched downloads: ONE int16 transfer (labels, the dominant bytes)
    # and ONE int32 transfer (winner + iters + costs) across ALL buckets
    from ..utils.dispatch import note
    note('eager', 2)
    note('d2h', 2 + (len(pending) if need_cents else 0))
    flat16 = np.asarray(jnp.concatenate(
        [p[1].reshape(-1) for p in pending]))
    flat32 = np.asarray(jnp.concatenate(
        [jnp.concatenate([p[3].reshape(-1).astype(jnp.int32),
                          p[4].reshape(-1).astype(jnp.int32),
                          p[5].reshape(-1).astype(jnp.int32)])
         for p in pending]))
    o16 = o32 = 0
    for lanes, labels_d, cents_d, winner_d, iters_d, costs_d in pending:
        g, n_pad = labels_d.shape
        k_pad = winner_d.shape[1]
        labels = flat16[o16:o16 + g * n_pad].reshape(g, n_pad)
        o16 += g * n_pad
        winner = flat32[o32:o32 + g * k_pad].reshape(g, k_pad)
        o32 += g * k_pad
        it_np = flat32[o32:o32 + g]
        o32 += g
        costs_np = flat32[o32:o32 + g * 3].reshape(g, 3)
        o32 += g * 3
        cents_np = np.asarray(cents_d) if need_cents else None
        if iters_out is not None:
            for j, i in enumerate(lanes):
                iters_out.append((len(exp_sel[i]), exp_k[i],
                                  int(it_np[j])))
        for j, i in enumerate(lanes):
            results[i] = (labels[j][:len(exp_sel[i])],
                          cents_np[j][:exp_k[i]] if need_cents else None,
                          winner[j][:exp_k[i]],
                          tuple(int(v) for v in costs_np[j]))

    out: list = [None] * b
    for i, owner in enumerate(exp_owner):
        lab, cen, win, cost = results[i]
        if out[owner] is None or cost < out[owner][3]:
            out[owner] = (lab, cen, win, cost)
    return [(lab, cen, win) for (lab, cen, win, _cost) in out]


def _size_buckets(bins_x, bins_k, floor: int = 4096,
                  n_modalities: int = 16, attr_count: int = 80,
                  temp_budget_bytes: int | None = None):
    """Group bins into pow2 size buckets (floor 4096): each bucket solves
    at ONE (n_pad, k_pad, g_pad) super-shape, so compile count stays small
    (<= ~3 shapes per encode) while the many median-size bins stop paying
    the biggest bin's padding (5x+ padded-point waste at 720p). Lane
    counts pad to pow2 with dummy lanes; big buckets chunk so the solver's
    HBM temporaries stay under temp_budget_bytes — the lane budget is in
    BYTES, not points, because make_dissim_fn's per-point one-hot
    encodings dominate: ~a*m*6 bytes of eq/convert temps plus
    ~a*(2m-1)*6 bytes of x_cat + fusion copies per padded point (~20KB
    a point at a=80, m=16). The default budget is a quarter of the
    device's memory limit."""
    if temp_budget_bytes is None:
        from ..utils.memory import device_bytes_limit
        temp_budget_bytes = device_bytes_limit() // 4
    a = attr_count
    m = n_modalities
    if m <= 32:
        per_point = a * m * 6 + a * (2 * m - 1) * 6
    else:  # broadcast dissim path materializes [n, k, a] int32 pairs
        per_point = a * 16
    point_budget = max(8192, temp_budget_bytes // per_point)
    buckets: dict[int, list[int]] = {}
    for i, xrow in enumerate(bins_x):
        n_pad = max(floor, _next_pow2(max(len(xrow), 8)))
        buckets.setdefault(n_pad, []).append(i)
    for n_pad in sorted(buckets):
        members = buckets[n_pad]
        k_pad = _next_pow2(max(max(bins_k[i] for i in members), 2))
        g_cap = max(1, point_budget // n_pad)
        lane_chunks = [members[lo:lo + g_cap]
                       for lo in range(0, len(members), g_cap)]
        g = _next_pow2(max(len(c) for c in lane_chunks)) \
            if len(lane_chunks) == 1 else g_cap
        g = min(g, max(1, point_budget // n_pad))
        yield dict(shape=(n_pad, k_pad, g, lane_chunks))


def min_dissim_index_last(rows: np.ndarray, target: np.ndarray) -> int:
    """GetMinMatchingDissim (kmodes.pas:598-612): index of the row with the
    smallest dissimilarity to target; ties take the LAST row (the asm scan
    uses <=)."""
    r = rows.astype(np.int64)
    t = target.astype(np.int64)
    d = ((r != t).sum(1) << DISSIM_SUB_MATCHING_BITS) + np.abs(r - t).sum(1)
    mins = np.flatnonzero(d == d.min())
    return int(mins[-1])
