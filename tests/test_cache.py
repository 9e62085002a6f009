"""Compile-cache placement (pathtracer/cache.py): JAX_COMPILATION_CACHE_DIR
wins when set; otherwise one fixed directory inside the checkout, which
.gitignore lists. Each case runs in a fresh interpreter, since JAX
settings are process-global."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
_PROBE = ("import jax; from pathtracer.cache import configure_compile_cache;"
          "p = configure_compile_cache();"
          "print(p); print(jax.config.jax_compilation_cache_dir)")


def _probe(env):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.strip().splitlines()


def test_cache_dir_unset_uses_checkout_directory():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env = {**env, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    want = str(ROOT / ".jax_cache")
    assert out == [want, want]
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cache_dir_env_is_honored(tmp_path):
    d = str(tmp_path / "cc")
    assert _probe({"JAX_COMPILATION_CACHE_DIR": d}) == [d, d]
