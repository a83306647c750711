"""Persistent compilation cache rule (utils/compile_cache.py): the
environment's ``JAX_COMPILATION_CACHE_DIR`` wins and nothing is set in
code; otherwise the caller's fixed directory is configured."""

import jax
import pytest

from coordinatedescent_jl_tpu.utils import compile_cache


@pytest.mark.parametrize("env", [None, "/cache/from/env"])
def test_enable_compile_cache(monkeypatch, env):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
    got = compile_cache.enable_compile_cache("/checkout/.jax_cache")
    if env is None:
        assert got == "/checkout/.jax_cache"
        assert calls == [("jax_compilation_cache_dir",
                          "/checkout/.jax_cache")]
    else:
        assert got == env and calls == []
