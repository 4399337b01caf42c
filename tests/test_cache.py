"""Persistent compile cache location (utils/cache.py)."""
import os

import jax

from icon_dvr.utils import cache


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.cache_dir() == str(tmp_path / "c")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
