"""Feasibility probe for exact IVF-style pruning of the FT stage-3 1-NN.

The stage-3 assign is an exact dense search over every candidate; one
way to speed it up is to visit fewer candidates. Exact pruning needs triangle-inequality ball bounds:
cluster the candidate features (k-means), then a query may skip cluster k
iff (d(q, mu_k) - r_k)^2 > u_q, where u_q is an upper bound from probing
the query's nearest cluster. This tool measures, on REAL content (the
reference's own city demo clip), what fraction of candidates a
query/block would actually visit — the go/no-go number for building the
pruned kernel path.

Usage: python tools/ft_prune_probe.py [n_clusters ...]
"""
from __future__ import annotations

import os
import sys
import time

# the probe counts candidates visited, which the CPU computes as well
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_FRAMES = 24
BLOCK = 2048


def get_state():
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.decode import decode_video
    from tiler_tpu.pipeline.encoder import Encoder
    frames, _ = decode_video(
        open('/root/reference/docs/demo/city_cif.gtm', 'rb').read())
    frames = frames[:N_FRAMES]
    cfg = EncoderConfig(palette_count=64, tile_palette_size=16,
                        end_step='global_tiling')
    enc = Encoder(cfg)
    enc.run_all(frames, fps=30.0)
    return enc.state


def main():
    ks = [int(a) for a in sys.argv[1:]] or [256, 512]
    from tiler_tpu.ops import features
    from tiler_tpu.ops.kmeans import kmeans
    from tiler_tpu.pipeline import frame_tiling as ft

    state = get_state()
    cfg = state.config
    ds, tile_of, attrs_of = ft.build_global_dataset(state)

    k = 0  # first keyframe only (representative)
    pal_mask = ft.palette_similarity_mask(state, k)
    used = ft.mark_candidates(state, k, ds, tile_of, attrs_of, pal_mask)
    feats, cand_pal, cand_tile, cand_attrs = ft.candidate_features(
        state, k, used, tile_of, attrs_of)
    C = np.asarray(feats)
    print(f'candidates: {len(C)}', flush=True)

    s, e = state.keyframes[k]
    src = np.asarray(state.device_source_tiles())
    base = s * state.tilemap_size
    n_q = (e - s + 1) * state.tilemap_size
    q_tiles = src[base:base + n_q]
    Q = np.asarray(features.psyv_features_rgb(
        q_tiles, gamma_value=None, use_wavelets=cfg.use_wavelets))
    print(f'queries: {len(Q)}', flush=True)

    c2 = (C.astype(np.float64) ** 2).sum(1)
    q2 = (Q.astype(np.float64) ** 2).sum(1)

    for n_cl in ks:
        t0 = time.perf_counter()
        labels, mu, _ = kmeans(C, n_cl, max_iters=25)
        labels = np.asarray(labels)
        mu = np.asarray(mu).astype(np.float64)
        # radii
        dm = ((C.astype(np.float64) - mu[labels]) ** 2).sum(1)
        r = np.zeros(n_cl)
        np.maximum.at(r, labels, np.sqrt(dm))
        sizes = np.bincount(labels, minlength=n_cl)
        t_cl = time.perf_counter() - t0

        # query-to-centroid distances
        dqmu = (q2[:, None] + (mu ** 2).sum(1)[None, :]
                - 2.0 * Q.astype(np.float64) @ mu.T)
        dqmu = np.sqrt(np.maximum(dqmu, 0))
        probe = dqmu.argmin(1)

        # u_q: exact best within probe cluster (chunked by cluster)
        u = np.full(len(Q), np.inf)
        order = np.argsort(labels, kind='stable')
        starts = np.searchsorted(labels[order], np.arange(n_cl + 1))
        for cl in range(n_cl):
            qm = probe == cl
            if not qm.any():
                continue
            rows = order[starts[cl]:starts[cl + 1]]
            if rows.size == 0:
                continue
            d = (q2[qm][:, None] + c2[rows][None, :]
                 - 2.0 * Q[qm].astype(np.float64) @ C[rows].T
                 ).min(1)
            u[qm] = np.maximum(d, 0)

        lb = np.maximum(dqmu - r[None, :], 0.0) ** 2
        # free (matmul-less) upper bound: nearest centroid + its radius
        u_tri = (dqmu.min(1) + r[probe]) ** 2

        print(f'k={n_cl}: cluster {t_cl:.1f}s  sizes mean={sizes.mean():.0f} '
              f'max={sizes.max()}  radius mean={r.mean():.2f} '
              f'max={r.max():.2f}', flush=True)
        qorder = np.argsort(probe, kind='stable')
        for uname, uq in (('exact-probe u', u), ('triangle u', u_tri)):
            keep = lb <= uq[:, None]          # [Q, n_cl]
            per_q = (keep * sizes[None, :]).sum(1) / len(C)
            line = (f'  [{uname}] per-query: mean={per_q.mean():.3f} '
                    f'p50={np.median(per_q):.3f} '
                    f'p90={np.quantile(per_q, .9):.3f}')
            for blk_sz in (BLOCK, 16384):
                kb = keep[qorder]
                fracs = []
                for lo in range(0, len(Q), blk_sz):
                    union = kb[lo:lo + blk_sz].any(0)
                    fracs.append((union * sizes).sum() / len(C))
                line += (f' | block{blk_sz}(sorted): mean='
                         f'{np.mean(fracs):.3f}')
            print(line, flush=True)


if __name__ == '__main__':
    main()
