"""Generate conformance cases for the REAL reference JS player.

Produces a staging directory with repo-encoded GTM streams plus per-frame
pixel hashes from our own decoder (tiler_tpu.decode.decode_video). The
harness.html page then plays each stream through the unmodified
/root/reference/decoders/htmljs/gtm.player.js and asserts the canvas
pixels hash-match frame by frame.

Cases:
  encoded  - full 8-step pipeline encode of synthetic multi-shot content:
             multi-keyframe, temporal smoothing (SkipBlock runs), mirrored
             tilemap attrs. The generator *asserts* those properties hold.
  long     - writer-constructed stream with >65536 tiles (LongTileIdx),
             256 palettes, palette reload on keyframe 2, full-frame skip
             runs exceeding the 1024-cell chunk limit, all 4 mirror combos.
  city     - the reference's own demo stream (legacy headerless form),
             checked against our decoder (decoder-side conformance).

Usage: python tools/js_conformance/gen_streams.py [outdir]
"""
from __future__ import annotations

import json
import os
import shutil
import sys

# the fixture streams are generated on the CPU, which any host has
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

REF_DEMO = '/root/reference/docs/demo'


def frame_hashes(frames: np.ndarray) -> list[list[int]]:
    """Per-frame [crc32, crc32-of-reversed] over raw RGB bytes. The
    harness computes the same pair in JS; two independent CRCs make an
    accidental per-frame collision (~2^-64) a non-issue."""
    import zlib
    out = []
    for f in frames:
        raw = np.ascontiguousarray(f).tobytes()
        out.append([zlib.crc32(raw) & 0xffffffff,
                    zlib.crc32(raw[::-1]) & 0xffffffff])
    return out


def synthetic_multishot(w=160, h=96, shots=3, shot_len=6, seed=7):
    """Multi-shot clip: static-ish backgrounds with a small moving block so
    temporal smoothing fires, hard cuts between shots so keyframe
    detection fires."""
    rng = np.random.default_rng(seed)
    frames = []
    for s in range(shots):
        # structurally independent background per shot: smooth random field
        # (Pearson correlation across shots ~0 => hard-cut keyframes)
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3))
        bg = np.stack([
            np.kron(coarse[..., c], np.ones((16, 16)))[:h, :w]
            for c in range(3)], axis=-1)
        bg = (bg * 0.7 + rng.integers(0, 256, (h, w, 3)) * 0.3
              ).astype(np.uint8)
        for t in range(shot_len):
            f = bg.copy()
            x0 = (8 + 16 * t) % (w - 24)
            y0 = (12 + 8 * t) % (h - 24)
            f[y0:y0 + 16, x0:x0 + 16] = [255 - 40 * s, 32 + 50 * s, 200]
            frames.append(f)
    return np.stack(frames)


def gen_encoded(outdir: str) -> dict:
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    from tiler_tpu.bitstream.gtm import parse_gtm, GTMCommand, CMD_BITS
    from tiler_tpu.decode import decode_video, interpret_commands

    frames = synthetic_multishot()
    cfg = EncoderConfig(palette_count=24, tile_palette_size=16,
                        smoothing_strength=0.06)
    enc = Encoder(cfg)
    blob = enc.run_all(frames, fps=24.0)

    parsed = parse_gtm(blob)
    assert parsed.header.kf_count >= 2, \
        f'need multi-keyframe, got {parsed.header.kf_count}'
    stream = interpret_commands(parsed)
    all_attrs = np.concatenate([f.attrs for f in stream.frames])
    assert ((all_attrs & 1) != 0).any(), 'no HMirror attrs in stream'
    assert ((all_attrs & 2) != 0).any(), 'no VMirror attrs in stream'
    n_drawn = sum(f.positions.size for f in stream.frames)
    n_cells = stream.tilemap_w * stream.tilemap_h * len(stream.frames)
    assert n_drawn < n_cells, 'no smoothed/skip cells in stream'

    dec, _ = decode_video(blob)
    path = os.path.join(outdir, 'encoded.gtm')
    open(path, 'wb').write(blob)
    return {'name': 'encoded', 'file': 'encoded.gtm',
            'frames': int(dec.shape[0]), 'width': int(dec.shape[2]),
            'height': int(dec.shape[1]), 'hashes': frame_hashes(dec)}


def gen_long(outdir: str) -> dict:
    """Writer-built stream: 66_000 tiles => LongTileIdx words, 256 palettes,
    second keyframe reloads palettes, full-frame skip run (1200 cells >
    1024 chunk cap), all mirror combos."""
    from tiler_tpu.bitstream.gtm import GTMWriter
    from tiler_tpu.decode import decode_video

    rng = np.random.default_rng(3)
    tw, th = 40, 30
    cells = tw * th
    n_tiles = 66_000
    pal_size = 16
    tiles = rng.integers(0, pal_size, (n_tiles, 8, 8), np.uint8)
    pals1 = rng.integers(0, 256, (256, pal_size, 3), np.uint8)
    pals2 = rng.integers(0, 256, (256, pal_size, 3), np.uint8)

    def mkframe(seed, smooth_all=False, force_long=True):
        r = np.random.default_rng(seed)
        tile_idx = r.integers(0, n_tiles, cells, np.int64)
        if force_long:
            tile_idx[::7] = r.integers(65536, n_tiles, (cells + 6) // 7)
        return {
            'tile_idx': tile_idx,
            'pal_idx': r.integers(0, 256, cells, np.int64),
            'hmir': r.integers(0, 2, cells).astype(bool),
            'vmir': r.integers(0, 2, cells).astype(bool),
            'smoothed': (np.ones(cells, bool) if smooth_all
                         else r.random(cells) < 0.3),
        }

    wr = GTMWriter(width=tw * 8, height=th * 8, fps=24.0, tiles_pal=tiles,
                   palette_size=pal_size, frame_count=4, kf_count=2)
    # frame 0 must draw every cell (nothing beneath to skip-preserve)
    f0 = mkframe(10)
    f0['smoothed'][:] = False
    wr.add_keyframe(0, 0, 1, pals1, [f0, mkframe(11, smooth_all=True)])
    wr.add_keyframe(1, 2, 3, pals2, [mkframe(12), mkframe(13)])
    blob = wr.tobytes()
    dec, _ = decode_video(blob)
    path = os.path.join(outdir, 'long.gtm')
    open(path, 'wb').write(blob)
    return {'name': 'long', 'file': 'long.gtm',
            'frames': int(dec.shape[0]), 'width': int(dec.shape[2]),
            'height': int(dec.shape[1]), 'hashes': frame_hashes(dec)}


def gen_demo(outdir: str, name: str) -> dict:
    """Reference demo stream: player-vs-our-decoder conformance on
    reference-produced bits (legacy headerless + lc=8 LZMA)."""
    from tiler_tpu.decode import decode_video
    src = os.path.join(REF_DEMO, f'{name}.gtm')
    blob = open(src, 'rb').read()
    dec, _ = decode_video(blob)
    shutil.copyfile(src, os.path.join(outdir, f'{name}.gtm'))
    return {'name': name, 'file': f'{name}.gtm',
            'frames': int(dec.shape[0]), 'width': int(dec.shape[2]),
            'height': int(dec.shape[1]), 'hashes': frame_hashes(dec)}


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else '/tmp/gtm_conformance'
    os.makedirs(outdir, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copyfile(os.path.join(here, 'harness.html'),
                    os.path.join(outdir, 'harness.html'))
    # reference player served verbatim (symlinked, never copied into repo)
    refdir = os.path.join(outdir, 'ref')
    os.makedirs(refdir, exist_ok=True)
    for f in ('gtm.player.js', 'lzma.js', 'lzma.shim.js'):
        dst = os.path.join(refdir, f)
        if not os.path.exists(dst):
            os.symlink(f'/root/reference/decoders/htmljs/{f}', dst)

    cases = []
    cases.append(gen_long(outdir))
    print('long: ok', cases[-1]['frames'], 'frames')
    cases.append(gen_demo(outdir, 'city_cif'))
    print('city_cif: ok', cases[-1]['frames'], 'frames')
    cases.append(gen_demo(outdir, 'football_cif'))
    print('football_cif: ok', cases[-1]['frames'], 'frames')
    cases.append(gen_encoded(outdir))
    print('encoded: ok', cases[-1]['frames'], 'frames')
    json.dump(cases, open(os.path.join(outdir, 'meta.json'), 'w'))
    print('staged at', outdir)


if __name__ == '__main__':
    main()
