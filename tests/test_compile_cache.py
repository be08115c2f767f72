"""The compile-cache rule of the entry points (utils/compile_cache.py):
follow $JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
import os

import jax
import pytest

from raytracingweekend_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir,
                                         tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env


def test_default_is_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cc.ENV, raising=False)
    path = cc.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_not_enabled_on_import():
    """Only entry points call enable_compile_cache(); importing the package
    (as this test process did) leaves JAX's setting alone."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != cc.ENV}
    code = ("import jax, raytracingweekend_tpu.render, "
            "raytracingweekend_tpu.grad; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"
