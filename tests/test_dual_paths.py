"""Consolidated bit-identity suite for every dual-implementation module.

Several steps have TWO implementations that must stay bit-equal — a pure
host/numpy path (used by the multi-host exact pipeline and as the oracle)
and a device-resident fast path (used by the single-host encoder). This
one parametrized suite pins each pair so perf work can't silently fork
them:

  - mirror canonicalization: canonicalize_mirrors vs the jitted device fn
  - MakeUnique: compute_unique_fwd vs compute_unique_fwd_device
  - GlobalTiling: compute_global_tiling_fwd vs ..._fwd_device
    (single-start AND multi-restart)
  - Knoll dithering: plain per-tile vs dedup-cached device variant
  - Yliluoma dithering: plain vs dedup-cached variant
  - GTS reload: deterministic run-to-run, host arrays vs device mirror
  - N-host == 1-host full-stream identity lives in test_parallel.py
    (test_exact_gop_sharded_matches_single_host) and stays there: it
    needs the full multi-host harness.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tiler_tpu.config import EncoderConfig
from tiler_tpu.pipeline.state import EncoderState


def _mk_state(rng, n=600, palette_count=8, dup_every=3):
    cfg = EncoderConfig(palette_count=palette_count, tile_palette_size=16)
    st = EncoderState(config=cfg)
    tiles = rng.integers(0, 16, (n, 8, 8)).astype(np.uint8)
    tiles[::dup_every] = tiles[0]
    st.tiles_pal = tiles
    st.tile_active = rng.random(n) > 0.1
    st.tile_use = rng.integers(1, 5, n).astype(np.int64)
    st.tile_dpi = rng.integers(0, palette_count, n).astype(np.int32)
    return st


def test_mirror_canonicalization_host_vs_device(rng):
    import jax
    from tiler_tpu.pipeline.dither_step import (_canonicalize_mirrors_dev,
                                                canonicalize_mirrors)
    tiles = rng.integers(0, 16, (300, 8, 8)).astype(np.uint8)
    baked_h, h_h, v_h = canonicalize_mirrors(tiles.copy())
    baked_d, bits_d = jax.jit(_canonicalize_mirrors_dev)(jnp.asarray(tiles))
    bits_d = np.asarray(bits_d)
    np.testing.assert_array_equal(baked_h, np.asarray(baked_d))
    np.testing.assert_array_equal(h_h, (bits_d & 1).astype(bool))
    np.testing.assert_array_equal(v_h, (bits_d >> 1).astype(bool))


def test_unique_host_vs_device(rng):
    from tiler_tpu.pipeline.unique import (compute_unique_fwd,
                                           compute_unique_fwd_device)
    st = _mk_state(rng)
    f_h, u_h, a_h, l_h = compute_unique_fwd(
        st.tiles_pal, st.tile_active, st.tile_use)
    st.set_tiles_pal_device(jnp.asarray(np.array(st.tiles_pal)))
    f_d, u_d, a_d, l_d = compute_unique_fwd_device(st)
    np.testing.assert_array_equal(f_h, f_d)
    np.testing.assert_array_equal(u_h, u_d)
    np.testing.assert_array_equal(a_h, a_d)
    np.testing.assert_array_equal(np.sort(l_h), np.sort(l_d))


@pytest.mark.parametrize('restarts', [0, 3])
def test_global_tiling_host_vs_device(rng, restarts):
    from tiler_tpu.pipeline.global_tiling import (
        compute_global_tiling_fwd, compute_global_tiling_fwd_device)
    st = _mk_state(rng, n=800, dup_every=1000)
    cfg = EncoderConfig(palette_count=8, tile_palette_size=16,
                        kmodes_restarts=restarts)
    st.config = cfg
    desired = 60
    f_h, u_h, a_h, m_h = compute_global_tiling_fwd(
        st.tiles_pal, st.tile_active, st.tile_use, st.tile_dpi,
        cfg, desired)
    host_tiles = np.array(st.tiles_pal)
    st.set_tiles_pal_device(jnp.asarray(host_tiles))
    st._tiles_pal_host = None
    f_d, u_d, a_d, m_d = compute_global_tiling_fwd_device(st, cfg, desired)
    np.testing.assert_array_equal(f_h, f_d)
    np.testing.assert_array_equal(u_h, u_d)
    np.testing.assert_array_equal(a_h, a_d)
    assert m_h == m_d


def test_knoll_plain_vs_cached(rng):
    from tiler_tpu.ops.dither import (knoll_dither_tiles,
                                      knoll_dither_tiles_cached)
    tiles = rng.integers(0, 255, (60, 8, 8, 3)).astype(np.uint8)
    pals = rng.integers(0, 255, (4, 16, 3)).astype(np.uint8)
    groups = rng.integers(0, 4, 60).astype(np.int32)
    plain = knoll_dither_tiles(tiles, pals[groups])
    cached = knoll_dither_tiles_cached(tiles, pals, groups)
    np.testing.assert_array_equal(plain, np.asarray(cached))


def test_yliluoma_plain_vs_cached(rng):
    from tiler_tpu.ops.dither import (yliluoma_dither_tiles,
                                      yliluoma_dither_tiles_cached)
    tiles = rng.integers(0, 255, (40, 8, 8, 3)).astype(np.uint8)
    pals = rng.integers(0, 255, (3, 16, 3)).astype(np.uint8)
    groups = rng.integers(0, 3, 40).astype(np.int32)
    plain = yliluoma_dither_tiles(tiles, pals[groups], mixed_colors=4)
    cached = yliluoma_dither_tiles_cached(tiles, pals, groups,
                                          mixed_colors=4)
    np.testing.assert_array_equal(plain, np.asarray(cached))


def test_reload_tiling_deterministic_and_device_equal(rng, tmp_path):
    """GTS reload: byte-deterministic run-to-run, and identical whether
    tiles_pal enters host- or device-resident."""
    from tiler_tpu.bitstream.gtm import write_gts
    from tiler_tpu.pipeline.encoder import Encoder

    frames = rng.integers(0, 255, (3, 48, 64, 3)).astype(np.uint8)
    cfg = EncoderConfig(palette_count=4, tile_palette_size=16, max_tiles=40)
    enc = Encoder(cfg)
    enc.load(frames, 24.0)
    enc.dither()
    enc.make_unique()
    enc.global_tiling()
    gts = str(tmp_path / 't.gts')
    act = np.flatnonzero(enc.state.tile_active)
    write_gts(gts, enc.state.tiles_pal[act], 16)

    def encode_with_reload():
        cfg2 = EncoderConfig(palette_count=4, tile_palette_size=16,
                             max_tiles=40, reload_tileset=gts)
        return Encoder(cfg2).run_all(frames, fps=24.0, fast_lzma=True)

    b1 = encode_with_reload()
    b2 = encode_with_reload()
    assert b1 == b2
