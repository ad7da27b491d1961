"""A/B measurement of the dither host/device overlap on a MULTI-keyframe
1080p clip (done-criterion: quantize substantially hidden on a
multi-keyframe 1080p bench, bytes identical).

One process, warm: encode a 3-shot 1080p clip with the software-pipelined
dither (default) and with TILER_NO_OVERLAP=1 (host quantize serialized),
and report both dither steps + whole walls + a stream byte comparison.
"""
import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit('/', 2)[0])


def multishot_1080p(f=18, h=1080, w=1920, seed=5):
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((f, h, w, 3), np.uint8)
    for i in range(f):
        shot = i // 6
        if shot == 0:
            pat = ((xx * 2 + i * 3) % 256)[..., None] * np.array([1, .8, .5])
        elif shot == 1:
            pat = ((yy * 3 + i * 5) % 256)[..., None] * np.array([.4, .6, 1])
        else:
            pat = (((xx + yy) + i * 7) % 256)[..., None] \
                * np.array([.9, 1, .3])
        frames[i] = np.clip(pat + rng.normal(0, 6, (h, w, 3)), 0, 255)
    return frames


def run(frames, overlap: bool):
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    os.environ.pop('TILER_NO_OVERLAP', None)
    if not overlap:
        os.environ['TILER_NO_OVERLAP'] = '1'
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    enc = Encoder(cfg)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=24.0, fast_lzma=True)
    wall = time.perf_counter() - t0
    st = enc.state
    return dict(wall_s=round(wall, 2),
                dither_s=round(st.step_times['dither'], 2),
                phases=st.metrics['dither_phases'],
                n_keyframes=st.metrics['n_keyframes']), blob


def main():
    frames = multishot_1080p()
    run(frames, overlap=True)  # warm (compiles)
    on, blob_on = run(frames, overlap=True)
    off, blob_off = run(frames, overlap=False)
    print(json.dumps(dict(
        overlap_on=on, overlap_off=off,
        bytes_identical=blob_on == blob_off,
        dither_saved_s=round(off['dither_s'] - on['dither_s'], 2),
        wall_saved_s=round(off['wall_s'] - on['wall_s'], 2))))


if __name__ == '__main__':
    main()
