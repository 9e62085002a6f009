"""Persistent XLA compilation cache placement.

Repeat renders skip the kernel compiles entirely (the reference pays its
OpenCL program build on every run, ocltracer.go:161-174). Where
JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory and
nothing here overrides it; otherwise the cache lives at one fixed,
git-ignored directory inside the checkout, so every entry point (CLI,
bench, chip_smoke) shares it and nothing is written outside the tree.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
