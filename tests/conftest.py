"""Test configuration: run on CPU with 8 virtual devices and x64 enabled.

SURVEY.md section 4 item 3: distributed tests without a cluster via
``xla_force_host_platform_device_count``; parity tests run in float64 to
match the MATLAB-double semantics of the reference.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: while_loop solvers are compile-heavy on CPU;
# caching makes repeated test runs fast.
from nmf_toolbox_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


# The XLA:CPU backend segfaults inside backend_compile_and_load after
# ~600 compilations in one process (reproduced at different tests purely
# by position once the suite grew past that).  Dropping compiled
# executables between modules keeps the per-process compiler state
# bounded; the persistent on-disk cache (above) makes the recompiles
# cheap loads.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compile_state():
    yield
    jax.clear_caches()
