"""Decode throughput benchmark on the demo streams (GTM decode frames/s).

Usage: python tools/decode_bench.py [path.gtm]
Prints one JSON line with fps for the native-parse + numpy-blit path and
the JAX scatter-render path.
"""
import json
import sys
import time

sys.path.insert(0, '.')


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        '/root/reference/docs/demo/city_cif.gtm'
    data = open(path, 'rb').read()

    from tiler_tpu.decode import decode_video, decode_video_jax
    # warm
    frames, stream = decode_video(data)
    t0 = time.perf_counter()
    frames, stream = decode_video(data)
    t_np = time.perf_counter() - t0

    result = {
        'metric': 'decode_fps',
        'stream': path.rsplit('/', 1)[-1],
        'frames': len(frames),
        'numpy_fps': round(len(frames) / t_np, 2),
    }
    from tiler_tpu.player import GTMPlayer
    t0 = time.perf_counter()
    n_streamed = sum(1 for _ in GTMPlayer(data).frames())
    t_pl = time.perf_counter() - t0
    result['player_fps'] = round(n_streamed / t_pl, 2)
    t0 = time.perf_counter()
    first = next(GTMPlayer(data).frames())
    result['player_first_frame_ms'] = round(
        (time.perf_counter() - t0) * 1000, 1)
    del first

    try:
        from tiler_tpu.decode import decode_video_jax_scan
        decode_video_jax_scan(data)  # warm
        t0 = time.perf_counter()
        js = decode_video_jax_scan(data)
        t_js = time.perf_counter() - t0
        result['jax_scan_fps'] = round(len(js) / t_js, 2)

        decode_video_jax(data)  # warm (per-frame dispatch layout)
        t0 = time.perf_counter()
        jx = decode_video_jax(data)
        t_jx = time.perf_counter() - t0
        result['jax_fps'] = round(len(jx) / t_jx, 2)
    except Exception as e:  # noqa: BLE001
        result['jax_error'] = str(e)[:120]
    print(json.dumps(result))


if __name__ == '__main__':
    main()
