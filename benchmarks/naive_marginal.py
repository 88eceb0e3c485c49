"""Long-dispatch (100 iters/call) rates for the non-Gram production
paths: KL nmf (naive fields) and euclidean cnmf (batched-shift Gram).

Whole-call timings at 30 iters/dispatch bake in the per-call host
round trip (see profile_flagship.py).
Chained-dispatch methodology; factors stay on device.

Usage: python benchmarks/naive_marginal.py {kl|cnmf|weighted} [--small]
"""
# repo root on sys.path: these scripts run as 'python benchmarks/x.py'
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

ITERS = 100
TRIALS = 4
SMALL = "--small" in sys.argv  # CPU harness smoke: tiny shapes, few iters
if SMALL:
    ITERS = 5
    TRIALS = 2
    jax.config.update("jax_platforms", "cpu")  # smoke mode runs on the CPU


def _dim(d):
    """Full benchmark dim, or /50 (min 8) under --small."""
    return max(8, d // 50) if SMALL else d


def time_chained(fn, args0, tag):
    out, fence = fn(*args0)
    float(np.ravel(fence)[-1])
    dts = []
    for _ in range(TRIALS):
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out, fence = fn(*out)
        f = float(np.ravel(fence)[-1])
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    med = sorted(dts)[len(dts) // 2]
    ms = med * 1e3 / ITERS
    print(f"{tag}: {ms:.2f} ms/iter ({ITERS/med:.1f} iters/s) fence={f:.4e}",
          flush=True)
    return ms


def main():
    positional = [a for a in sys.argv[1:] if not a.startswith("-")]
    which = positional[0]
    print(f"device: {jax.devices()[0]}", flush=True)
    from nmf_toolbox_tpu.core import EPS
    r = {}

    if which in ("kl", "weighted"):
        from nmf_toolbox_tpu.models.nmf import _build_solver, _Spec
        m, n, k = _dim(40_000), _dim(10_000), _dim(100)
        kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
        V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
        W0 = jax.random.uniform(kw, (m, k), jnp.float32)
        H0 = jax.random.uniform(kh, (k, n), jnp.float32)
        jax.block_until_ready(V)
        spec = _Spec("kl", 1.0, 1.0, "naive", ITERS,
                     (False,), (False,), ((0, k),), EPS)
        solve = _build_solver(spec)
        zeros = jnp.zeros((k,), jnp.float32)
        tol = jnp.float32(1e-30)
        if which == "kl":
            def fn(W, H):
                out = solve(V, W, H, zeros, zeros, tol)
                return out.state, out.cost_buf
            r[f"kl_{m}_{n}_r{k}"] = time_chained(fn, (W0, H0),
                                                 f"KL nmf {m} x {n} r{k}")
        else:
            Mw = (jax.random.uniform(jax.random.PRNGKey(9), (m, n))
                  < 0.8).astype(jnp.float32)
            jax.block_until_ready(Mw)

            def fn(W, H):
                out = solve(V, W, H, zeros, zeros, tol, Mw)
                return out.state, out.cost_buf
            r[f"weighted_kl_{m}_{n}_r{k}"] = time_chained(
                fn, (W0, H0), f"weighted-KL nmf {m} x {n} r{k}")

    if which == "cnmf":
        from nmf_toolbox_tpu.models.cnmf import (_build_solver as _cn_build,
                                                 _Spec as _CnSpec)
        m, n, k, T = _dim(513), _dim(10_000), _dim(64), 4 if SMALL else 8
        kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
        V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
        W0 = jax.random.uniform(kw, (m, k, T), jnp.float32)
        H0 = jax.random.uniform(kh, (k, n), jnp.float32)
        jax.block_until_ready(V)
        spec = _CnSpec("euclidean", 1.0, 1.0, T, ITERS,
                       (False,), (False,), ((0, k),), EPS, "gram")
        solve = _cn_build(spec)
        zeros = jnp.zeros((k,), jnp.float32)
        tol = jnp.float32(1e-30)

        def fn(W, H):
            out = solve(V, W, H, zeros, zeros, tol)
            return out.state, out.cost_buf
        r[f"cnmf_{m}_{n}_r{k}_T{T}"] = time_chained(
            fn, (W0, H0), f"cnmf euclid-gram {m} x {n} r{k} T{T}")

    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
