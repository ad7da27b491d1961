"""Sharding tests on the 8-device virtual CPU mesh."""
import jax
import numpy as np
import pytest

from tiler_tpu.parallel import mesh as pmesh
from tiler_tpu.parallel import sharded_ops
from tiler_tpu.parallel.distributed import assign_gops_to_hosts


@pytest.fixture(scope='module')
def mesh8():
    assert len(jax.devices()) >= 8
    return pmesh.make_mesh(8)


def test_mesh_shape(mesh8):
    assert dict(zip(mesh8.axis_names, mesh8.devices.shape)) == \
        {'rows': 8}


def test_sharded_features_match_single(rng, mesh8):
    tiles = rng.integers(0, 256, (500, 8, 8, 3)).astype(np.uint8)
    from tiler_tpu.ops import features
    want = np.asarray(features.psyv_features_rgb(tiles, use_wavelets=True))
    got = sharded_ops.sharded_psyv_features(mesh8, tiles, use_wavelets=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_sharded_kmeans_shard_invariance(rng, mesh8):
    """N-device k-means must equal the 1-device run (order-independent
    reductions; SURVEY.md §4d)."""
    centers = rng.normal(0, 10, (4, 32))
    pts = np.concatenate(
        [c + rng.normal(0, .1, (64, 32)) for c in centers]).astype(np.float32)
    mesh1 = pmesh.make_mesh(1)
    lab8, c8 = sharded_ops.sharded_kmeans(mesh8, pts, 4)
    lab1, c1 = sharded_ops.sharded_kmeans(mesh1, pts, 4)
    np.testing.assert_array_equal(lab8, lab1)
    np.testing.assert_allclose(c8, c1, rtol=1e-5, atol=1e-5)
    # and it actually clusters
    for g in range(4):
        assert len(np.unique(lab8[g * 64:(g + 1) * 64])) == 1


def test_sharded_nearest_matches_single(rng, mesh8):
    q = rng.normal(0, 1, (300, 64)).astype(np.float32)
    c = rng.normal(0, 1, (900, 64)).astype(np.float32)
    idx8, err8 = sharded_ops.sharded_nearest_1(mesh8, q, c)
    from tiler_tpu.ops import knn
    idx1, err1 = knn.nearest_1(q, c)
    d8 = ((q - c[idx8]) ** 2).sum(1)
    d1 = ((q - c[idx1]) ** 2).sum(1)
    np.testing.assert_allclose(d8, d1, rtol=1e-4, atol=1e-3)


def test_gop_assignment_balanced():
    kfs = np.array([[0, 9], [10, 99], [100, 149], [150, 159]])
    owner = assign_gops_to_hosts(kfs, 2)
    sizes = kfs[:, 1] - kfs[:, 0] + 1
    loads = [sizes[owner == h].sum() for h in range(2)]
    assert abs(loads[0] - loads[1]) <= 50


def test_dryrun_entrypoints():
    import __graft_entry__ as g
    fn, args = g.entry()
    idx, err = fn(*args)
    assert idx.shape == (args[0].shape[0],)
    g.dryrun_multichip(8)


def test_gop_sharded_encode_decodes(rng):
    """BASELINE config #5 structure: GOPs partitioned across workers,
    per-keyframe tileset segments, one valid GTM out."""
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.decode import decode_video
    from tiler_tpu.ops.stats import psnr
    from tiler_tpu.parallel.distributed import encode_gop_sharded

    f, h, w = 8, 40, 56
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        base = ((xx * 4 + i * 3) % 256)[..., None] * np.array([1, .7, .4])
        if i >= 5:
            base = ((yy * 5 + 64) % 256)[..., None] * np.array([.3, .9, 1.])
        frames[i] = np.clip(base + rng.normal(0, 5, (h, w, 3)), 0, 255)

    cfg = EncoderConfig(palette_count=4, tile_palette_size=16)
    blob = encode_gop_sharded(frames, cfg, n_hosts=2)
    dec, stream = decode_video(blob)
    assert dec.shape == frames.shape
    assert len(stream.frames) == f
    assert float(psnr(dec, frames)) > 18.0


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_sharded_kmodes_matches_single_device(rng, n_dev):
    """N-device distributed KModes (psum'd category counts) must equal the
    single-device solver BIT-FOR-BIT — the SURVEY §5.8(b) shard-invariance
    guarantee that makes N-host global tilesets identical to 1-host."""
    from jax.sharding import Mesh
    from tiler_tpu.ops.kmodes import kmodes

    x = rng.integers(0, 16, (403, 80)).astype(np.uint8)
    x[:, 64:] = x[:, 64:] & 1
    k, start = 23, 7
    want_labels, want_cents = kmodes(x, k, start, n_modalities=16)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ('km',))
    got_labels, got_cents = sharded_ops.sharded_kmodes(
        mesh, x, k, start, n_modalities=16)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_cents, want_cents)


def _multi_scene_clip(rng, scenes=3, frames_per=5, h=64, w=80):
    """Clip with hard cuts so keyframe detection yields multiple GOPs."""
    out = []
    for s in range(scenes):
        base = np.zeros((h, w, 3), np.float64)
        base[..., s % 3] = 200
        base += np.linspace(0, 55, w)[None, :, None] * ((-1) ** s)
        blob = rng.integers(0, 60, (h, w, 3))
        for f in range(frames_per):
            fr = base + np.roll(blob, f * 3, axis=1)
            out.append(np.clip(fr, 0, 255).astype(np.uint8))
    return np.stack(out)


def test_exact_gop_sharded_matches_single_host(rng):
    """SURVEY §4(d): an N-host GOP-sharded encode with the cross-host
    tileset collectives produces the BYTE-IDENTICAL stream of the 1-host
    encoder."""
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    from tiler_tpu.parallel.gop_exact import encode_gop_sharded_exact

    frames = _multi_scene_clip(rng)
    enc = Encoder(EncoderConfig(palette_count=8, max_tiles=300))
    want = enc.run_all(frames, fps=24.0, fast_lzma=True)
    assert len(enc.state.keyframes) >= 3, 'clip must split into >=3 GOPs'

    for n_hosts in (1, 2, 3):
        got = encode_gop_sharded_exact(
            frames, EncoderConfig(palette_count=8, max_tiles=300),
            n_hosts=n_hosts, fps=24.0, fast_lzma=True)
        assert got == want, f'{n_hosts}-host stream differs from 1-host'


def test_exact_gop_sharded_with_device_sharded_kmodes(rng, mesh8):
    """Full distributed stack: GOPs across hosts x KModes across the
    8-device mesh (psum'd category counts) — still byte-identical."""
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    from tiler_tpu.parallel.gop_exact import encode_gop_sharded_exact

    frames = _multi_scene_clip(rng, scenes=2, frames_per=4)
    enc = Encoder(EncoderConfig(palette_count=8, max_tiles=200))
    want = enc.run_all(frames, fps=24.0, fast_lzma=True)
    got = encode_gop_sharded_exact(
        frames, EncoderConfig(palette_count=8, max_tiles=200),
        n_hosts=2, fps=24.0, fast_lzma=True, kmodes_mesh=mesh8)
    assert got == want


def test_distributed_two_process_encode(tmp_path, rng):
    """Real multi-process path: two jax.distributed CPU processes (gloo)
    running the CLI --distributed encode produce the byte-identical
    stream of the single-host encoder."""
    import os
    import socket
    import subprocess
    import sys

    frames = _multi_scene_clip(rng, scenes=2, frames_per=4)
    clip = tmp_path / 'clip.npy'
    np.save(clip, frames)

    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder
    want = Encoder(EncoderConfig(palette_count=8, max_tiles=200)).run_all(
        frames, fps=24.0, fast_lzma=True)

    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    out = tmp_path / 'dist.gtm'
    env = {**os.environ, 'JAX_PLATFORMS': 'cpu',
           'PYTHONPATH': os.path.dirname(os.path.dirname(__file__))}
    env.pop('XLA_FLAGS', None)
    args = [sys.executable, '-m', 'tiler_tpu', 'encode', str(clip),
            None, '--palette-count', '8', '--max-tiles', '200',
            '--fast-lzma', '--fps', '24.0', '--distributed',
            '--coordinator', f'localhost:{port}', '--num-processes', '2']
    procs = []
    for pid in (0, 1):
        a = list(args)
        a[5] = str(out) if pid == 0 else os.devnull
        procs.append(subprocess.Popen(a + ['--process-id', str(pid)],
                                      env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL))
    for p in procs:
        assert p.wait(timeout=300) == 0
    assert out.read_bytes() == want


def test_mesh_encode_byte_identical(rng, mesh8):
    """The full production encode with the device mesh wired into the
    pipeline (frame-sharded
    FrameTiling mark/feats/assign + distributed KModes via
    mesh_kmodes=True, parallel.mesh_pipeline) is byte-identical to the
    1-device encode.

    The clip has a static band (temporal query dedup active, non-dense
    path) and two keyframes, so the sharded stages see the gather path,
    the forward-fill path, and per-keyframe candidate sets."""
    from __graft_entry__ import _dryrun_clip
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder

    frames = _dryrun_clip()  # shared with dryrun_multichip: one scenario

    cfg = EncoderConfig(palette_count=8, tile_palette_size=16,
                        max_tiles=120, mesh_kmodes=True)
    want = Encoder(cfg).run_all(frames, fast_lzma=True)
    enc = Encoder(cfg, mesh=mesh8)
    got = enc.run_all(frames, fast_lzma=True)
    assert got == want, 'mesh encode differs from single-device encode'
    # the run really exercised the interesting sharded paths
    assert len(enc.state.keyframes) >= 2
    assert enc.state.metrics['ft_q_changed_frac'] < 1.0


def test_ft_row_budget_grouping_byte_identical(monkeypatch):
    """Forcing the FrameTiling HBM row budget down to one keyframe per
    group (the long-clip memory-bound path with a flush sync between
    groups) leaves the stream byte-identical to the single-group
    schedule."""
    from __graft_entry__ import _dryrun_clip
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder

    frames = _dryrun_clip()  # two keyframes
    cfg = EncoderConfig(palette_count=8, tile_palette_size=16,
                        max_tiles=120)
    want = Encoder(cfg).run_all(frames, fast_lzma=True)
    from tiler_tpu.pipeline import frame_tiling
    monkeypatch.setattr(frame_tiling, '_row_budget', lambda: 1)
    got = Encoder(cfg).run_all(frames, fast_lzma=True)
    assert got == want, 'per-keyframe grouping changed the stream'


@pytest.mark.parametrize('axis', [0, 1])
def test_per_device_rows_runs_the_single_device_program(rng, mesh8, axis):
    """per_device_rows splits the rows over the devices, hands every
    device the replicated arguments whole, and reassembles the outputs
    in row order as one array sharded over the mesh."""
    import jax.numpy as jnp
    from tiler_tpu.parallel.mesh_pipeline import per_device_rows, replicate

    rows = rng.integers(0, 100, (64, 4) if axis == 0 else (3, 64))
    table = rng.normal(0, 1, (100,)).astype(np.float32)
    fn = jax.jit(lambda r, t: (t[r].sum(axis=1 - axis), r.sum(axis=1 - axis)))
    want = fn(jnp.asarray(rows), jnp.asarray(table))
    got = per_device_rows(mesh8, fn, rows, replicate(mesh8, table),
                          axis=axis)
    for g, w in zip(got, want):
        assert len(g.sharding.device_set) == 8
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_sharded_unique_matches_host(rng, n_dev):
    """The round-5 distributed MakeUnique (hash-partitioned all_to_all +
    per-shard radix dedup) must produce the CANONICAL winner map — equal
    to the host np.unique dedup — at every device count. Tiles include
    forced duplicates, mirror-baked lookalikes, an all-0xFF row (which
    shares bytes with the sentinel padding pattern), and zeros."""
    import jax.numpy as jnp

    from tiler_tpu.pipeline.unique import compute_unique_fwd

    n = 700
    tiles = rng.integers(0, 16, (n, 8, 8)).astype(np.uint8)
    tiles[50] = tiles[10]
    tiles[51] = tiles[10]
    tiles[600] = tiles[599]
    tiles[42] = 0xFF
    tiles[43] = 0xFF
    tiles[44] = 0
    active = np.ones(n, bool)
    active[::13] = False  # inactive rows must not join any group
    use = rng.integers(1, 5, n).astype(np.int64)

    fwd_want, use_want, act_want, _ = compute_unique_fwd(
        tiles, active, use)

    mesh = pmesh.make_mesh(n_dev)
    act = np.flatnonzero(active)
    sidx, winner = sharded_ops.sharded_unique(
        mesh, jnp.asarray(tiles), act, n)
    valid = sidx < n
    fwd_got = np.arange(n)
    fwd_got[sidx[valid]] = winner[valid]
    np.testing.assert_array_equal(fwd_got, fwd_want)


def test_mesh_unique_and_sigs_in_full_encode(rng, mesh8):
    """Full mesh encode exercising the round-5 sharded MakeUnique +
    GT signature build: still byte-identical to the 1-device encode
    (the dedup winners are canonical; the signatures are exact ints)."""
    from __graft_entry__ import _dryrun_clip
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.pipeline.encoder import Encoder

    frames = _dryrun_clip()
    cfg = EncoderConfig(palette_count=8, tile_palette_size=16,
                        max_tiles=120)
    want = Encoder(cfg).run_all(frames, fast_lzma=True)
    got = Encoder(cfg, mesh=mesh8).run_all(frames, fast_lzma=True)
    assert got == want
