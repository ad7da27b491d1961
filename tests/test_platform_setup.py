"""Where the compile cache goes, and which native library gets loaded."""
import os

import jax
import pytest

from tiler_tpu import compile_cache, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('platform,environ,want', [
    ('gpu', {'JAX_COMPILATION_CACHE_DIR': '/some/cache'}, '/some/cache'),
    ('cpu', {'JAX_COMPILATION_CACHE_DIR': '/some/cache'}, '/some/cache'),
    ('gpu', {}, compile_cache.CHECKOUT_CACHE_DIR),
    ('cpu', {}, None),
])
def test_compile_cache_dir(platform, environ, want):
    """The environment variable wins; otherwise the GPU gets one fixed
    path inside the checkout and the CPU gets no cache."""
    assert compile_cache.cache_dir(platform, environ) == want


def test_checkout_cache_dir_is_fixed_and_ignored():
    assert os.path.dirname(compile_cache.CHECKOUT_CACHE_DIR) == ROOT
    with open(os.path.join(ROOT, '.gitignore')) as f:
        ignored = f.read().split()
    assert os.path.basename(compile_cache.CHECKOUT_CACHE_DIR) + '/' \
        in ignored


def test_enable_leaves_cpu_uncached(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() is None
    assert jax.config.jax_compilation_cache_dir == before


_SRC = {'a.cc': b'int f() { return 1; }', 'b.cc': b'int g();'}


@pytest.mark.parametrize('sources,target,same', [
    (_SRC, b'x86-64 avx2', True),
    ({**_SRC, 'a.cc': b'int f() { return 2; }'}, b'x86-64 avx2', False),
    (_SRC, b'x86-64 avx512f', False),
])
def test_native_library_keyed_on_sources_and_target(sources, target, same):
    """A library built from other sources, or for another host's CPU, has
    another file name, so it is never loaded in place of this one."""
    base = native.lib_path(_SRC, b'x86-64 avx2')
    got = native.lib_path(sources, target)
    assert (got == base) is same
    assert os.path.dirname(got) == native._BUILD_DIR


def test_native_library_loaded_from_current_sources():
    lib = native.get_lib()
    want = native.lib_path(native._read_sources(), native._compiler_target())
    assert lib._name == want and os.path.exists(want)
