"""The persistent compilation cache has one source: JAX_COMPILATION_CACHE_DIR
when it is set, else the fixed `<checkout>/.jax_cache`."""

import os

import jax
import pytest

from fvens_tpu import compile_cache


@pytest.mark.parametrize("env_dir", ["/some/cache/dir", None])
def test_enable_compile_cache(monkeypatch, env_dir):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV, env_dir)

    path = compile_cache.enable_compile_cache()

    if env_dir is None:
        checkout = os.path.dirname(os.path.dirname(
            os.path.abspath(compile_cache.__file__)))
        assert path == os.path.join(checkout, ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == path
    else:
        assert path == env_dir
        assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0
