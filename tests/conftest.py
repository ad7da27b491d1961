"""Test harness config: the tests run on the CPU backend with 8 virtual
devices, so that they need no GPU and the sharding tests get a mesh.
Tests of what runs only on the card carry the `gpu` marker and take the
`gpu_device` fixture, which skips them here; chip_smoke.py runs those
paths on the card."""
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('JAX_ENABLE_X64', '0')

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs an NVIDIA GPU; skipped on other backends')


@pytest.fixture
def rng():
    return np.random.default_rng(42381337)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided at run time,
    never at import, so every test worker collects the same tests)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        pytest.skip('needs an NVIDIA GPU (run chip_smoke.py on the card)')
    return devs[0]
