"""The persistent compile cache lands where the environment says, and at
``<repo>/.jax_cache`` otherwise (utils/compile_cache.py).

Each case runs a fresh interpreter: JAX fixes the cache directory at the
first compile of a process, and the suite's own processes keep the cache
off (tests/conftest.py).
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

from liquid_usrp_tpu.utils.compile_cache import REPO_CACHE_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compile_in_child(env_dir, token: str) -> tuple[str, str]:
    """Place the cache, compile a function unique to ``token``; returns
    (printed cache dir, the new program's name prefix)."""
    const = int(hashlib.sha256(token.encode()).hexdigest()[:6], 16)
    name = f"cache_probe_{const}"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from liquid_usrp_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        f"def {name}(x):\n"
        f"    return x * {const}.0 + 1.0\n"
        f"jax.jit({name})(jnp.ones(7)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1], f"jit_{name}-"


def _entries(d, prefix):
    return [f for f in os.listdir(d) if f.startswith(prefix)] \
        if os.path.isdir(d) else []


def test_cache_follows_env_var(tmp_path):
    where, prefix = _compile_in_child(tmp_path, str(tmp_path))
    assert where == str(tmp_path)
    assert _entries(tmp_path, prefix)
    assert not _entries(REPO_CACHE_DIR, prefix)


def test_cache_defaults_to_repo_dir(tmp_path):
    before = set(_entries(REPO_CACHE_DIR, ""))
    try:
        where, prefix = _compile_in_child(None, "repo:" + str(tmp_path))
        assert where == str(REPO_CACHE_DIR)
        assert REPO_CACHE_DIR == Path(ROOT) / ".jax_cache"
        assert _entries(REPO_CACHE_DIR, prefix)
    finally:                              # leave the repo cache as it was
        for f in set(_entries(REPO_CACHE_DIR, "")) - before:
            os.remove(os.path.join(REPO_CACHE_DIR, f))
