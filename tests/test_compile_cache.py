"""Placement of the persistent compile cache (runner.compilation_cache_dir)."""

import os

from hammlet_tpu.runner import DEFAULT_CACHE_DIR, compilation_cache_dir


def test_cache_dir_is_the_env_directory_itself():
    env = {"JAX_COMPILATION_CACHE_DIR": "/x"}
    assert compilation_cache_dir(env) == "/x"


def test_cache_dir_defaults_to_the_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compilation_cache_dir({}) == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
