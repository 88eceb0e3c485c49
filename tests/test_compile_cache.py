"""utils/compile_cache: the persistent compilation cache lives in
JAX_COMPILATION_CACHE_DIR when that is set, else in <checkout>/.jax_cache,
and nowhere else."""
import os
import pathlib
import subprocess
import sys

from nmf_toolbox_tpu.utils.compile_cache import CHECKOUT_CACHE

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
from nmf_toolbox_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
salt = int(sys.argv[1])
exec(f"def probe_{salt}(x):\n    return x * {salt}.0 + 1.0")
print(float(jax.jit(globals()[f"probe_{salt}"])(2.0)))
"""


def _run(env):
    """Compile one uniquely named function in a fresh process; returns
    (the cache directory reported, the function's name)."""
    salt = int.from_bytes(os.urandom(3), "little")
    p = subprocess.run([sys.executable, "-c", _CHILD, str(salt)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.splitlines()[0], f"probe_{salt}"


def _entries(path, name=""):
    path = pathlib.Path(path)
    if not path.exists():
        return []
    return [p for p in path.rglob("*") if name in p.name]


def _base_env(tmp_path):
    home, tmp = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmp.mkdir()
    env = dict(os.environ, HOME=str(home), TMPDIR=str(tmp),
               PYTHONPATH=str(ROOT))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env, home, tmp


def test_cache_in_checkout_without_env(tmp_path):
    env, home, tmp = _base_env(tmp_path)
    where, name = _run(env)
    assert where == str(CHECKOUT_CACHE)
    assert _entries(CHECKOUT_CACHE, name), "no entry in <checkout>/.jax_cache"
    assert not _entries(home) and not _entries(tmp)


def test_cache_only_in_env_dir_when_set(tmp_path):
    env, home, tmp = _base_env(tmp_path)
    cache = tmp_path / "jaxcache"
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    where, name = _run(env)
    assert where == str(cache)
    assert _entries(cache, name), "no entry in JAX_COMPILATION_CACHE_DIR"
    assert not _entries(CHECKOUT_CACHE, name)
    assert not _entries(home) and not _entries(tmp)
