"""Benchmark: end-to-end GTM encode throughput at the north-star
resolution (1080p) on the default backend, against a single-host CPU run
of the same pipeline as the baseline (the reference Pascal encoder is a
Windows binary and cannot run here; see BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N,
   "step_times": {...}, "phases": {...}, "psnr": N, ...}

The timed run is steady-state: an untimed warm-up encode at the same
shapes compiles every kernel first. The CPU baseline uses fewer frames
(per-frame work dominates; fixed costs are excluded by per-frame
normalization) and is skipped gracefully on timeout.

The headline value is the MEDIAN of TILER_BENCH_RUNS timed encodes
(default 5). The headline clip is `synthetic_clip_v2`: three scenes with
hard cuts and a ~38%-static band, so the number of record exercises the
shipping machinery (keyframe detection, per-keyframe quantize overlap,
temporal query dedup, skip-block encoding) instead of the pathological
single-scene all-noise schedule; the old clip rides along once as a
`continuity` entry. A real-content entry (the reference's own 300-frame
city_cif demo, decoded and re-encoded) rides along in the same JSON line
when that stream is present.

Env knobs: TILER_BENCH_SMALL=1 -> 320x240 clip;
TILER_BENCH_NO_CPU=1 -> skip the CPU-baseline subprocess;
TILER_BENCH_NO_REAL=1 -> skip the real-content entry;
TILER_BENCH_NO_CONT=1 -> skip the continuity (old-clip) entry;
TILER_BENCH_RUNS=N -> timed-run count for the median (default 5).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

SMALL = os.environ.get('TILER_BENCH_SMALL') == '1'
H, W, F = (240, 320, 16) if SMALL else (1080, 1920, 16)
# CPU baseline: shorter clip, same per-frame work (per-frame
# normalization; 2 frames at 1080p keep the subprocess ~5 min on a
# 2-core host — it was >20 and the whole-bench wall must stay inside
# the driver's patience with the 5-run median). Bias note: fixed costs
# amortize over fewer frames, so cpu_fps is UNDERSTATED and
# vs_baseline somewhat overstated — read it as order-of-magnitude
# (~100x), not a calibrated ratio.
F_CPU = 8 if SMALL else 2
PAL = 32 if SMALL else 128


def synthetic_clip(f, h, w, seed=0):
    """Former headline clip: one scene, full-frame motion+noise (every
    cell changes every frame, single keyframe). Kept as the CONTINUITY
    entry this round; see synthetic_clip_v2 for why the headline moved."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        base = ((xx * 2 + i * 3) % 256)[..., None] * np.array([1, .8, .5])
        base += ((yy + 2 * i) % 64)[..., None] * np.array([.2, .5, 1.])
        frames[i] = np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255)
    return frames


def synthetic_clip_v2(f, h, w, seed=0):
    """Headline clip: three scenes (hard cuts -> 3 keyframes) and
    a static bottom band (~38% of cells unchanged within a scene).

    The single-scene all-noise clip measured the schedule LEAST
    representative of real content: no quantize/k-means overlap partner,
    no temporal query dedup, no cross-keyframe batching. Real video has shots and static regions — the reference's
    own keyframe detector and skip-block encoder exist because of them
    (main.pas:1099-1155, 4677-4719). Scene patterns differ enough that
    the detector's hard threshold fires at each cut."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    h_static = (int(h * 0.38) // 8) * 8      # whole 8px tile rows
    cuts = [0, (f * 3) // 8, (f * 11) // 16, f]   # 16 -> scenes 6/5/5
    mixes = [np.array([[1., .7, .4], [.2, .5, 1.]]),
             np.array([[.3, 1., .5], [1., .3, .6]]),
             np.array([[.5, .4, 1.], [.9, .8, .2]])]
    for s in range(3):
        lo, hi = cuts[s], cuts[s + 1]
        mix = mixes[s]
        # per-scene static band content (noise frozen within the scene)
        if s == 0:
            sb = ((xx * 3) % 256)[..., None] * mix[0]
        elif s == 1:
            sb = ((yy * 2 + xx) % 256)[..., None] * mix[1]
        else:
            sb = (((xx // 4) * 7) % 256)[..., None] * mix[0]
        static_band = np.clip(
            sb[h - h_static:] + rng.normal(0, 6, (h_static, w, 3)),
            0, 255).astype(np.uint8)
        for i in range(lo, hi):
            t = i - lo
            if s == 0:
                base = ((xx * 2 + t * 3) % 256)[..., None] * mix[0] \
                    + ((yy + 2 * t) % 64)[..., None] * mix[1]
            elif s == 1:
                base = ((yy * 2 - t * 5) % 256)[..., None] * mix[0] \
                    + (((xx + yy) // 2 + t) % 96)[..., None] * mix[1]
            else:
                base = (((xx + yy) + t * 4) % 256)[..., None] * mix[0] \
                    + ((xx % 128 + t) % 128)[..., None] * mix[1]
            frames[i] = np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255)
            frames[i, h - h_static:] = static_band
    return frames


def _bench_mesh():
    """TILER_BENCH_DEVICES=N (N>1, pow2): run the production mesh path
    across N local devices — the scaling config for multi-GPU hosts.
    The default stays 1."""
    n = int(os.environ.get('TILER_BENCH_DEVICES', '1'))
    if n <= 1:
        return None
    import jax

    from tiler_tpu.parallel.mesh import make_mesh
    from tiler_tpu.parallel.mesh_pipeline import mesh_ok
    if n > len(jax.devices()):
        raise SystemExit(f'TILER_BENCH_DEVICES={n}: only '
                         f'{len(jax.devices())} device(s) available')
    mesh = make_mesh(n)
    if not mesh_ok(mesh):
        raise SystemExit(f'TILER_BENCH_DEVICES={n}: must be a power of '
                         'two (a silent single-device fallback would '
                         'mislabel the scaling numbers)')
    return mesh


def encode_once(frames, warm: bool = True, runs: int = 1):
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    cfg = EncoderConfig(palette_count=PAL, tile_palette_size=16)
    mesh = _bench_mesh()
    if warm:
        # warmup at the SAME shapes: shape-bucketed kernels compile here
        # so the timed run measures steady-state throughput
        Encoder(cfg, mesh=mesh).run_all(frames, fps=24.0, fast_lzma=True)
    all_fps = []
    for _ in range(max(runs, 1)):
        enc = Encoder(cfg, mesh=mesh)
        t0 = time.perf_counter()
        blob = enc.run_all(frames, fps=24.0, fast_lzma=True)
        dt = time.perf_counter() - t0
        all_fps.append(len(frames) / dt)
    return all_fps, enc, blob


def _dispatch_total(st) -> int:
    """Pipeline-issued device interactions (jit dispatches + eager ops +
    H2D/D2H transfers) over the whole encode (utils.dispatch)."""
    d = st.metrics.get('dispatches') or {}
    return sum(v.get('total', 0) for v in d.values())


def real_content_entry():
    """Re-encode the reference's own 300-frame city demo (352x288@30) —
    the dedup-exercising real-content config (tools/bench_city.py's
    operating point: 64 palettes, the demo's own budget)."""
    ref_path = '/root/reference/docs/demo/city_cif.gtm'
    if not os.path.exists(ref_path) or \
            os.environ.get('TILER_BENCH_NO_REAL') == '1':
        return None
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.decode import decode_video
    from tiler_tpu.pipeline.encoder import Encoder
    src = open(ref_path, 'rb').read()
    frames, _ = decode_video(src)
    n = int(os.environ.get('TILER_BENCH_REAL_FRAMES', '0'))
    if n:
        frames = frames[:n]  # debug knob; the driver runs the full clip
    cfg = EncoderConfig(palette_count=64, tile_palette_size=16)
    # FULL-CLIP warm: a 64-frame prefix warms DIFFERENT pow2 shape
    # buckets than the full clip (tile counts 101k vs 475k, per-keyframe
    # candidate sets), so the measured run would pay XLA compiles for
    # every unwarmed bucket. Doubling the bench wall for a steady-state
    # measurement is the honest trade.
    Encoder(cfg).run_all(frames, fps=30.0, fast_lzma=True)
    enc = Encoder(cfg)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=30.0, fast_lzma=True)
    dt = time.perf_counter() - t0
    dec, _ = decode_video(blob)
    mse = np.mean((dec.astype(np.float64) - frames.astype(np.float64)) ** 2)
    st = enc.state
    return {
        'metric': 'encode_city_cif_300f',
        'wall_s': round(dt, 2),
        'fps': round(len(frames) / dt, 3),
        'psnr': round(float(10 * np.log10(255.0 ** 2 / mse)), 3)
        if mse else 99.0,
        'gtm_bytes': len(blob),
        'ref_gtm_bytes': len(src),
        'n_keyframes': st.metrics.get('n_keyframes'),
        'ft_q_changed_frac': st.metrics.get('ft_q_changed_frac'),
        'ft_pair_dedup': st.metrics.get('ft_pair_dedup'),
        'n_dispatches': _dispatch_total(st),
        'dispatches': st.metrics.get('dispatches'),
        'step_times': {k: round(v, 2) for k, v in st.step_times.items()},
        'phases': {
            'dither': st.metrics.get('dither_phases'),
            'global_tiling': st.metrics.get('gt_phases'),
            'frame_tiling': st.metrics.get('ft_phases'),
        },
        'mesh_sharded_wall': st.metrics.get('mesh_sharded_wall'),
    }


def continuity_entry():
    """One timed run of the rounds-1-4 single-scene noise clip (own
    warm-up: its 1-keyframe shapes compile different buckets than the
    3-keyframe headline clip), so the headline-clip switch stays
    comparable across rounds. TILER_BENCH_NO_CONT=1 skips."""
    if os.environ.get('TILER_BENCH_NO_CONT') == '1':
        return None
    frames = synthetic_clip(F, H, W)
    all_fps, enc, _blob = encode_once(frames, runs=1)
    return {
        'metric': f'encode_fps_{W}x{H}_noise16_r1_clip',
        'fps': round(all_fps[0], 3),
        'step_times': {k: round(v, 2)
                       for k, v in enc.state.step_times.items()},
    }


def main():
    if os.environ.get('TILER_BENCH_CPU') == '1':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        frames = synthetic_clip_v2(F_CPU, H, W)
        all_fps, _, _ = encode_once(frames, warm=False)
        print(json.dumps({'cpu_fps': all_fps[0]}))
        return

    import jax
    backend = jax.default_backend()
    frames = synthetic_clip_v2(F, H, W)
    runs = int(os.environ.get('TILER_BENCH_RUNS', '5'))
    all_fps, enc, blob = encode_once(frames, runs=runs)
    fps = float(np.median(all_fps))

    psnr = None
    try:
        from tiler_tpu.decode import decode_video
        dec, _ = decode_video(blob)
        mse = np.mean((dec.astype(np.float64) -
                       frames.astype(np.float64)) ** 2)
        psnr = round(float(10 * np.log10(255.0 ** 2 / mse)), 3) if mse \
            else 99.0
    except Exception:
        pass

    # CPU baseline in a subprocess (fresh process so the backend choice and
    # compile caches don't leak); failures/timeouts fall back to 1.0
    vs_baseline = 1.0
    if os.environ.get('TILER_BENCH_NO_CPU') != '1':
        try:
            env = dict(os.environ, TILER_BENCH_CPU='1')
            out = subprocess.run([sys.executable, __file__], env=env,
                                 capture_output=True, text=True,
                                 timeout=1200)
            for line in out.stdout.strip().splitlines():
                try:
                    cpu_fps = json.loads(line).get('cpu_fps')
                    if cpu_fps:
                        vs_baseline = fps / cpu_fps
                except json.JSONDecodeError:
                    continue
        except Exception:
            pass

    try:
        real = real_content_entry()
    except Exception:
        # a broken real-content path must be distinguishable from an
        # intentional skip: keep the headline entry alive, dump why
        import traceback
        traceback.print_exc(file=sys.stderr)
        real = None
    try:
        continuity = continuity_entry()
    except Exception:
        import traceback
        traceback.print_exc(file=sys.stderr)
        continuity = None

    st = enc.state
    headline = {
        'metric': f'encode_fps_{W}x{H}_{backend}',
        'value': round(fps, 3),
        'unit': 'frames/s',
        'clip': 'cuts_v2',
        'vs_baseline': round(vs_baseline, 3),
        'runs_fps': [round(v, 3) for v in all_fps],
        'psnr': psnr,
        'n_keyframes': st.metrics.get('n_keyframes'),
        'q_changed': st.metrics.get('ft_q_changed_frac'),
        'load_s': round(st.step_times.get('load', 0.0), 2),
        'quantize_s': round((st.metrics.get('dither_phases') or {})
                            .get('quantize', 0.0), 2),
        'real_wall_s': real.get('wall_s') if real else None,
        'real_fps': real.get('fps') if real else None,
        'continuity_fps': continuity.get('fps') if continuity else None,
    }
    print(json.dumps({
        'metric': f'encode_fps_{W}x{H}_{backend}',
        'value': round(fps, 3),
        'unit': 'frames/s',
        'clip': 'cuts_v2',
        'runs_fps': [round(v, 3) for v in all_fps],
        'vs_baseline': round(vs_baseline, 3),
        'psnr': psnr,
        'gtm_bytes': len(blob),
        'real_content': real,
        'continuity': continuity,
        'n_dispatches': _dispatch_total(st),
        'dispatches': st.metrics.get('dispatches'),
        'step_times': {k: round(v, 2) for k, v in st.step_times.items()},
        'phases': {
            'dither': st.metrics.get('dither_phases'),
            'global_tiling': st.metrics.get('gt_phases'),
            'frame_tiling': st.metrics.get('ft_phases'),
        },
        'ft_pair_dedup': st.metrics.get('ft_pair_dedup'),
        'ft_q_changed_frac': st.metrics.get('ft_q_changed_frac'),
        'mesh_sharded_wall': st.metrics.get('mesh_sharded_wall'),
    }))
    # Compact headline repeated LAST: a reader that keeps only the tail
    # of the output still gets the headline fields.
    print(json.dumps(headline))


if __name__ == '__main__':
    main()
