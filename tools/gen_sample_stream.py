"""Generate the small self-contained demo stream (decoders/web/sample.gtm).

Synthetic content (no third-party footage): an animated plasma field with
a few moving sprites and one hard cut, sized so the checked-in stream
stays small while still exercising keyframes, smoothing skip-runs, mirror
attrs and multiple palettes.

Usage: python tools/gen_sample_stream.py [out.gtm]
"""
from __future__ import annotations

import os
import sys

# the checked-in stream is generated on the CPU, which any host has
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def sample_clip(w=320, h=176, n=48):
    """Two shots of animated plasma + moving sprites."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        shot = i >= n // 2
        t = i * 0.25
        if not shot:
            v = (np.sin(xx * 0.045 + t) + np.sin(yy * 0.06 - 0.7 * t)
                 + np.sin((xx + yy) * 0.03 + 0.4 * t))
            r = 128 + 90 * np.sin(v * 1.1)
            g = 128 + 90 * np.sin(v * 1.1 + 2.1)
            b = 128 + 90 * np.sin(v * 1.1 + 4.2)
        else:
            v = (np.sin(np.hypot(xx - w / 2, yy - h / 2) * 0.07 - t)
                 + np.sin(xx * 0.02 + 2 * t))
            r = 110 + 100 * np.sin(v + 1.0)
            g = 120 + 80 * np.sin(v * 1.3)
            b = 150 + 100 * np.sin(v * 0.8 - 1.0)
        f = np.stack([r, g, b], -1)
        # moving sprites (sharp edges exercise tile reuse + mirrors)
        for s in range(3):
            cx = int((w - 40) * (0.5 + 0.45 * np.sin(t * (0.6 + 0.2 * s)
                                                     + s * 2.1))) + 20
            cy = int((h - 40) * (0.5 + 0.45 * np.cos(t * (0.5 + 0.15 * s)
                                                     + s * 1.3))) + 20
            col = np.array([[255, 230, 40], [40, 220, 255],
                            [255, 70, 160]][s], np.float32)
            f[cy - 10:cy + 10, cx - 10:cx + 10] = col
        frames[i] = np.clip(f, 0, 255).astype(np.uint8)
    return frames


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, 'decoders', 'web', 'sample.gtm')
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    from tiler_tpu.decode import decode_video

    frames = sample_clip()
    cfg = EncoderConfig(palette_count=32, tile_palette_size=16,
                        qb_tiles=1.0)
    enc = Encoder(cfg)
    blob = enc.run_all(frames, fps=24.0)
    dec, _stream = decode_video(blob)
    mse = np.mean((dec.astype(np.float64) - frames.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    open(out, 'wb').write(blob)
    print(f'{out}: {len(blob)} bytes, {dec.shape[0]} frames '
          f'{dec.shape[2]}x{dec.shape[1]}, PSNR {psnr:.2f} dB')


if __name__ == '__main__':
    main()
