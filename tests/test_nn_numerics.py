"""The exact 1-NN against float64, the numerics contract as the lowered
HLO shows it, and chip_smoke's comparison rule and refusal to run off the
GPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiler_tpu.ops import features, kmeans, knn, numerics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402



def _nn64(q, c):
    q, c = q.astype(np.float64), c.astype(np.float64)
    d = (q * q).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * q @ c.T
    return d.argmin(1), d


def _run(q, c):
    idx, err = jax.jit(knn.argmin_1nn)(jnp.asarray(q), knn.pad_candidates(c))
    return np.asarray(idx), np.asarray(err)


@pytest.mark.parametrize('d', [64, 192])
@pytest.mark.parametrize('n_q,n_c', [(200, 700), (256, knn.C_CHUNK + 300)])
def test_argmin_1nn_matches_float64(rng, d, n_q, n_c):
    """One chunk and several (the running argmin crosses a chunk edge)."""
    q = rng.normal(0, 1, (n_q, d)).astype(np.float32)
    c = rng.normal(0, 1, (n_c, d)).astype(np.float32)
    idx, err = _run(q, c)
    want, dist = _nn64(q, c)
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(err, dist[np.arange(n_q), want],
                               rtol=1e-4, atol=1e-3)


def test_nearest_1_host_wrapper_chunks_queries(rng):
    """The host API splits queries into chunks, pads each to a power of
    two and trims the results back."""
    q = rng.normal(0, 1, (1500, 64)).astype(np.float32)
    c = rng.normal(0, 1, (900, 64)).astype(np.float32)
    idx, err = knn.nearest_1(q, c, q_chunk=512)
    assert idx.shape == err.shape == (1500,)
    np.testing.assert_array_equal(idx, _nn64(q, c)[0])


def test_padded_candidates_never_win(rng):
    """Queries far from every real candidate still pick a real one: the
    1e9 padding rows (C_CHUNK - 5 of them here) never win."""
    q = rng.normal(0, 1, (64, 192)).astype(np.float32) * 1e3
    c = rng.normal(0, 1, (5, 192)).astype(np.float32)
    idx, _ = _run(q, c)
    assert idx.max() < 5
    np.testing.assert_array_equal(idx, _nn64(q, c)[0])


def test_lowest_index_wins_ties():
    """Exact duplicates inside one chunk and across chunks: the lowest
    candidate index wins."""
    base = np.eye(4, 192, dtype=np.float32) * 3
    c = np.zeros((knn.C_CHUNK + 8, 192), np.float32) + 50
    c[[1, 2]] = base[0]                        # in-chunk duplicate
    c[[67, knn.C_CHUNK + 1]] = base[1]         # across chunks
    c[[knn.C_CHUNK + 7, knn.C_CHUNK + 3]] = base[2]
    idx, _ = _run(base[:3], c)
    np.testing.assert_array_equal(idx, [1, 67, knn.C_CHUNK + 3])


# -- numerics contract: the pin shows in the lowered HLO -------------------

_Q = jax.ShapeDtypeStruct((256, 192), jnp.float32)
_C = jax.ShapeDtypeStruct((knn.C_CHUNK, 192), jnp.float32)
_OPS = {
    'knn_argmin_1nn': (knn.argmin_1nn, (_Q, _C)),
    'knn_scan_topk': (lambda q, c: knn._scan_topk(q, c, 8), (_Q, _C)),
    'psyv_features': (
        lambda t: features.psyv_from_cpn(t, use_wavelets=True),
        (jax.ShapeDtypeStruct((256, 3, 8, 8), jnp.float32),)),
    'kmeans_assign': (lambda x, c: kmeans._assign(x, jnp.sum(x * x, 1), c),
                      (_Q, jax.ShapeDtypeStruct((128, 192), jnp.float32))),
    'kmeans_seed': (
        lambda x: kmeans._plus_plus_init(x, 4, jax.random.PRNGKey(0)),
        (_Q,)),
}
_WANT = {
    'cpu': 'precision = [HIGHEST, HIGHEST]',
    'cuda': ('algorithm = <lhs_precision_type = tf32, rhs_precision_type '
             '= tf32, accumulation_type = f32, lhs_component_count = 1, '
             'rhs_component_count = 1, num_primitive_operations = 3'),
}


@pytest.mark.parametrize('platform', ['cpu', 'cuda'])
@pytest.mark.parametrize('op', sorted(_OPS))
def test_stream_deciding_dots_carry_contract_precision(op, platform,
                                                       monkeypatch):
    """Every float32 dot of the op lowers with the contract precision for
    the platform (the CPU ignores precision, so only the HLO shows it)."""
    monkeypatch.setattr(numerics, '_platform',
                        lambda: 'gpu' if platform == 'cuda' else 'cpu')
    fn, args = _OPS[op]
    jax.clear_caches()   # drop traces made under the other platform
    try:
        text = jax.export.export(jax.jit(fn), platforms=[platform])(
            *args).mlir_module()
    finally:
        jax.clear_caches()
    dots = [ln for ln in text.splitlines()
            if 'stablehlo.dot_general' in ln and 'xf32>' in ln]
    assert dots, f'{op}: no float32 dot found'
    for ln in dots:
        assert _WANT[platform] in ln, ln


# -- chip_smoke's comparison rule and its refusal to run off the GPU ------

@pytest.mark.parametrize('case,want', [
    ('exact', (0, 0)), ('near_tie', (1, 0)), ('wrong', (0, 1))])
def test_nn_mismatches_tolerates_only_near_ties(case, want):
    q = np.zeros((1, 4))
    q[0, 0] = 1.0
    c = np.array([[1.0, 0, 0, 0],                       # the minimum
                  [1.0, 1e-4, 0, 0],                    # near-tie
                  [0.0, 0, 0, 0]])                      # far off
    got = {'exact': 0, 'near_tie': 1, 'wrong': 2}[case]
    assert chip_smoke.nn_mismatches(np.array([got]), q, c,
                                    rtol=1e-5) == want


@pytest.mark.parametrize('alone', [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (and, `alone`, no repo beside the script): exit non-zero and
    print no result line."""
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        with open(script) as f:
            (tmp_path / 'chip_smoke.py').write_text(f.read())
        script = str(tmp_path / 'chip_smoke.py')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_argmin_1nn_matches_float64_on_gpu(rng, gpu_device):
    """The 1-NN at the GPU's contract precision (chip_smoke.py's kernel
    phase checks it at production widths)."""
    q = rng.normal(0, 1, (512, 192)).astype(np.float32)
    c = rng.normal(0, 1, (4096, 192)).astype(np.float32)
    idx, _ = _run(q, c)
    assert chip_smoke.nn_mismatches(idx, q, c)[1] == 0
