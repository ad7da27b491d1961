"""Multi-host orchestration: jax.distributed init + GOP sharding across
hosts (the SURVEY.md §5.7/§5.8 long-clip scaling design).

Topology: keyframe spans (GOPs) are distributed round-robin across hosts;
within a host, frames/tiles shard across the local devices
(parallel.sharded_ops). The global artifacts every host needs — the
reduced tileset and palette centroids — are exchanged with allgather-style
collectives; host 0 concatenates the per-GOP command streams into the
final GTM (all host file I/O stays on host 0, like the reference's single
writer, main.pas:4529).
"""
from __future__ import annotations

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or env (JAX_COORDINATOR etc.).
    No-op when single-process."""
    import os
    import jax
    coordinator = coordinator or os.environ.get('JAX_COORDINATOR')
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ['JAX_NUM_PROCESSES'])
    if process_id is None:
        process_id = int(os.environ['JAX_PROCESS_ID'])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes, process_id=process_id)


def assign_gops_to_hosts(keyframes: np.ndarray, n_hosts: int) -> np.ndarray:
    """[K] host id per keyframe, balanced by frame count (greedy)."""
    sizes = keyframes[:, 1] - keyframes[:, 0] + 1
    order = np.argsort(-sizes, kind='stable')
    load = np.zeros(n_hosts, np.int64)
    owner = np.zeros(len(keyframes), np.int32)
    for k in order:
        h = int(np.argmin(load))
        owner[k] = h
        load[h] += sizes[k]
    return owner


def encode_gop_sharded(frames: np.ndarray, config, n_hosts: int = 2,
                       fps: float = 24.0, fast_lzma: bool = True) -> bytes:
    """GOP-sharded encode producing ONE valid GTM stream.

    The multi-host execution shape of BASELINE config #5: keyframes are
    detected globally, partitioned across `n_hosts` workers, each worker
    encodes its GOPs independently (its own tileset + palettes), and host 0
    assembles the final stream — each keyframe carries its own gtTileSet
    segment at a disjoint index range, so any GTM player decodes the
    result. In a real multi-host run each partition executes on its own
    host (parallel.distributed.init_distributed); here workers run
    sequentially in-process, which is bit-identical to the distributed
    result by construction (per-GOP encodes are independent).

    Trade-off vs the single-host encoder: no cross-GOP tile sharing, so
    streams are somewhat larger (documented divergence until the
    cross-host KModes allreduce lands).
    """
    from ..pipeline.encoder import Encoder
    from ..pipeline.load import detect_keyframes
    from ..bitstream.gtm import GTMWriter

    probe = Encoder(config)
    probe.load(frames, fps=fps)
    keyframes = probe.state.keyframes
    width, height = probe.state.screen_w, probe.state.screen_h
    owner = assign_gops_to_hosts(keyframes, n_hosts)

    results = []
    for h in range(n_hosts):
        results.extend(encode_gop_partition(frames, keyframes, owner, h,
                                            config))
    results.sort(key=lambda r: r['kf_index'])

    total_tiles = sum(len(r['tiles_pal']) for r in results)
    writer = GTMWriter(width=width, height=height, fps=fps,
                       tiles_pal=None,
                       palette_size=config.tile_palette_size,
                       frame_count=len(frames), kf_count=len(results),
                       fast_lzma=fast_lzma,
                       total_tile_count=total_tiles,
                       lzma_mode=config.lzma_mode)
    offset = 0
    for r in results:
        st = r['state']
        kf_frames = []
        n_local = st.n_frames
        for f in range(n_local):
            kf_frames.append(dict(
                tile_idx=st.stm_tile[f].ravel() + offset,
                pal_idx=st.stm_pal[f].ravel(),
                hmir=st.stm_h[f].ravel(),
                vmir=st.stm_v[f].ravel(),
                smoothed=st.stm_smooth[f].ravel()))
        writer.add_keyframe(
            r['kf_index'], r['start'], r['end'], r['palettes_rgb'],
            kf_frames, tileset=(offset, r['tiles_pal']))
        offset += len(r['tiles_pal'])
    return writer.tobytes()


def encode_gop_partition(frames: np.ndarray, keyframes: np.ndarray,
                         owner: np.ndarray, my_host: int, config):
    """Encode only the keyframes owned by this host; returns per-KF
    (palettes, frame dicts, state metrics) ready for host-0 assembly.

    Each GOP is an independent encode (the reference's keyframes are
    self-contained except for the shared global tileset, which multi-host
    runs rebuild per GOP partition — a documented divergence until the
    cross-host KModes allreduce lands)."""
    from ..pipeline.encoder import Encoder

    results = []
    for k in np.flatnonzero(owner == my_host):
        s, e = keyframes[k]
        enc = Encoder(config)
        enc.load(frames[s:e + 1])
        # single-KF clip: force one keyframe spanning the GOP
        enc.state.keyframes = np.array([[0, e - s]], np.int32)
        enc.dither()
        enc.make_unique()
        enc.global_tiling()
        enc.frame_tiling()
        enc.reindex()
        enc.smooth()
        n_act = int(enc.state.tile_active.sum())
        results.append(dict(
            kf_index=int(k), start=int(s), end=int(e),
            tiles_pal=enc.state.tiles_pal[:n_act],
            palettes_rgb=enc.state.palettes_rgb[0],
            state=enc.state))
    return results
