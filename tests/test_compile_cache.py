"""One compile-cache rule for every entry point
(``svtyper_tpu.utils.compile_cache``)."""

import os

import jax
import pytest

from svtyper_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_cache_dir_rule(env_set, tmp_path, monkeypatch, restore_cache_config):
    marker = str(tmp_path / "nowhere-else")
    jax.config.update("jax_compilation_cache_dir", marker)
    if env_set:
        want = str(tmp_path / "from-env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(REPO, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.enable_compile_cache() == want
    assert os.path.isdir(want)
    # with the variable set JAX reads it itself: nothing else is named
    assert jax.config.jax_compilation_cache_dir == (
        marker if env_set else want
    )
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_checkout_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_unwritable_cache_dir_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker / "cache"))
    with pytest.raises(OSError):
        compile_cache.enable_compile_cache()
