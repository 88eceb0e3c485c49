"""Profile the flagship gram step.

Questions this answers with on-device data:

1. Where does the time per iteration at 100k x 10k r200 f32 go?  The
   two V-touching matmuls (V @ H' at nmf.m:149, W' @ V at nmf.m:180)
   are 8e11 FLOP/iter and read the 4 GB f32 V twice (8 GB/iter; bf16 V
   halves that).
2. Does bf16 V storage help (round 1 said ~3%), and do explicit
   pre-transposed operands / donated buffers move anything?

Measured (this file, round 2): f32 8.83 ms/iter, bf16 8.54 ms/iter.

Methodology: chained dispatches whose inputs depend on the previous
output, scalar host readback as the completion fence, discard the first
post-warmup trial, report the median.

Usage: python benchmarks/profile_flagship.py [job ...]
jobs: f32 bf16 vt_f32 vt_bf16 donate hlo   (default: f32 bf16)
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

from nmf_toolbox_tpu.models.nmf import _build_solver, _Spec
from nmf_toolbox_tpu.core import EPS
from nmf_toolbox_tpu.ops.normalize import unit_l2_columns

import os

M = int(os.environ.get("PF_M", 100_000))
N = int(os.environ.get("PF_N", 10_000))
K = int(os.environ.get("PF_K", 200))
ITERS = int(os.environ.get("PF_ITERS", 20))
TRIALS = 4  # first discarded
if "--small" in sys.argv:  # CPU harness smoke: tiny shapes, few iters
    M, N, K, ITERS = 2048, 512, 16, 5
    jax.config.update("jax_platforms", "cpu")  # smoke mode runs on the CPU


def make_problem(data_dtype):
    key = jax.random.PRNGKey(0)
    kv, kw, kh = jax.random.split(key, 3)
    V = jax.random.uniform(kv, (M, N), jnp.float32, 0.05, 1.0)
    V = V.astype(data_dtype)
    W0 = unit_l2_columns(jax.random.uniform(kw, (M, K), jnp.float32))
    H0 = jax.random.uniform(kh, (K, N), jnp.float32)
    jax.block_until_ready(V)
    return V, W0, H0


def time_chained(fn, args_fn, tag):
    """fn(*args) -> (new_args, fence_array); chained across trials."""
    args = args_fn()
    out, fence = fn(*args)
    float(np.ravel(fence)[-1])
    dts = []
    for trial in range(TRIALS):
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out, fence = fn(*out)
        f = float(np.ravel(fence)[-1])
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    med = sorted(dts)[len(dts) // 2]
    ms = med * 1e3 / ITERS
    print(f"{tag}: {ms:.2f} ms/iter ({ITERS/med:.1f} iters/s) "
          f"trials={['%.2f' % (d*1e3/ITERS) for d in dts]} fence={f:.3e}",
          flush=True)
    return ms


def production_runner(solve, V):
    zeros = jnp.zeros((K,), jnp.float32)
    tol = jnp.float32(1e-30)

    def fn(W, H):
        out = solve(V, W, H, zeros, zeros, tol)
        return out.state, out.cost_buf
    return fn


def job_production(data_dtype, tag, w_fixed=False, h_fixed=False):
    spec = _Spec("euclidean", 1.0, 1.0, "gram", ITERS,
                 (w_fixed,), (h_fixed,), ((0, K),), EPS)
    solve = _build_solver(spec)
    V, W0, H0 = make_problem(data_dtype)
    return time_chained(production_runner(solve, V), lambda: (W0, H0), tag)


def gram_step_vt(V, VT, W, H, eps):
    """One production gram iteration with an explicitly pre-transposed
    second operand: dot2 reads VT (n, m) in its natural layout."""
    cdt = jnp.float32
    HHt = H @ H.T
    VHt = jax.lax.dot(V, H.T.astype(V.dtype), preferred_element_type=cdt)
    WG = W @ HHt
    dneg = jnp.sum(W * WG, axis=0)
    dpos = jnp.sum(W * VHt, axis=0)
    neg = VHt + W * dneg[None, :]
    pos = WG + W * dpos[None, :]
    Wn = W * (neg / jnp.maximum(pos, eps))
    Wn = unit_l2_columns(Wn)
    WtV = jax.lax.dot(VT, Wn.astype(VT.dtype), preferred_element_type=cdt).T
    WtW = Wn.T @ Wn
    Hn = H * (WtV / jnp.maximum(WtW @ H, eps))
    v_sq = jnp.float32(1.0)  # cost constant is irrelevant for timing
    c = jnp.maximum(0.5 * (v_sq - 2.0 * jnp.sum(WtV * Hn)
                           + jnp.sum((WtW @ Hn) * Hn)), 0.0)
    return Wn, Hn, c


def job_vt(data_dtype, tag):
    V, W0, H0 = make_problem(data_dtype)
    # materialize V' as its own (n, m) default-layout array on device
    VT = jax.jit(lambda x: jnp.swapaxes(x, 0, 1).copy())(V)
    jax.block_until_ready(VT)
    eps = jnp.float32(EPS)

    # V / VT are ARGUMENTS (a closed-over device array would become a
    # 4 GB jit constant)
    @jax.jit
    def run(V, VT, W, H):
        def body(c, _):
            W, H = c
            Wn, Hn, cost = gram_step_vt(V, VT, W, H, eps)
            return (Wn, Hn), cost
        (W, H), costs = jax.lax.scan(body, (W, H), None, length=ITERS)
        return (W, H), costs

    def fn(W, H):
        return run(V, VT, W, H)

    return time_chained(fn, lambda: (W0, H0), tag)


def job_donate(tag):
    spec = _Spec("euclidean", 1.0, 1.0, "gram", ITERS,
                 (False,), (False,), ((0, K),), EPS)
    # rebuild the underlying solver with donated factor buffers
    import importlib
    nmfmod = importlib.import_module("nmf_toolbox_tpu.models.nmf")
    inner = nmfmod._build_solver_impl(spec)
    # inner is already jitted without donation; wrap the raw impl instead
    V, W0, H0 = make_problem(jnp.float32)
    zeros = jnp.zeros((K,), jnp.float32)
    tol = jnp.float32(1e-30)

    solve = jax.jit(inner.__wrapped__, donate_argnums=(1, 2)) \
        if hasattr(inner, "__wrapped__") else None
    if solve is None:
        print("donate: cannot unwrap jit; skipping", flush=True)
        return None

    def fn(W, H):
        out = solve(V, W, H, zeros, zeros, tol)
        return out.state, out.cost_buf
    return time_chained(fn, lambda: (W0, H0), tag)


def job_hlo():
    spec = _Spec("euclidean", 1.0, 1.0, "gram", ITERS,
                 (False,), (False,), ((0, K),), EPS)
    solve = _build_solver(spec)
    for dt, tag in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        V, W0, H0 = make_problem(dt)
        zeros = jnp.zeros((K,), jnp.float32)
        tol = jnp.float32(1e-30)
        txt = solve.lower(V, W0, H0, zeros, zeros, tol).compile().as_text()
        big = [l for l in txt.splitlines()
               if ("100000,10000" in l or "10000,100000" in l)
               and ("transpose(" in l or "convert(" in l or "copy(" in l)]
        print(f"{tag} HLO: {len(big)} full-size layout/convert ops, "
              f"{txt.count('fusion(')} fusions", flush=True)
        for l in big[:8]:
            print("   ", l.strip()[:150], flush=True)


def main():
    jobs = [a for a in sys.argv[1:] if not a.startswith("-")] \
        or ["f32", "bf16"]
    print(f"device: {jax.devices()[0]}", flush=True)
    r = {}
    for j in jobs:
        if j == "f32":
            r[j] = job_production(jnp.float32, "production f32 V")
        elif j == "bf16":
            r[j] = job_production(jnp.bfloat16, "production bf16 V")
        elif j == "wfix":
            # W phase disabled: remaining cost = WtV dot + H update + cost
            r[j] = job_production(jnp.float32, "production f32, W fixed",
                                  w_fixed=True)
        elif j == "hfix":
            # H update elementwise disabled (WtV still computed for cost)
            r[j] = job_production(jnp.float32, "production f32, H fixed",
                                  h_fixed=True)
        elif j == "accel4":
            spec = _Spec("euclidean", 1.0, 1.0, "gram", ITERS,
                         (False,), (False,), ((0, K),), EPS, None, None, 4)
            solve = _build_solver(spec)
            V, W0, H0 = make_problem(jnp.float32)
            r[j] = time_chained(production_runner(solve, V),
                                lambda: (W0, H0),
                                "production f32, inner_iters=4")
        elif j == "vt_f32":
            r[j] = job_vt(jnp.float32, "VT-passed f32")
        elif j == "vt_bf16":
            r[j] = job_vt(jnp.bfloat16, "VT-passed bf16")
        elif j == "donate":
            r[j] = job_donate("donated buffers f32")
        elif j == "hlo":
            job_hlo()
        else:
            raise SystemExit(f"unknown job {j}")
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
