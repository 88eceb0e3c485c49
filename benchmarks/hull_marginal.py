"""Marginal per-iteration cost of the hull family at the BASELINE #5
scale (100k x 10k rank-200).

Whole-call figures for convexnmf/seminmf bundle the one-time n-by-n Gram
(2e13 FLOPs for convexnmf) and compile into 10-30 iterations.  The marginal
MU iteration itself never touches the m-by-n V again (convexnmf.m:94-101 run
in Gram space; chnmf.m:177-199 in (p, n)/(k, n) space), so the steady-state
rate is far higher.

Method: build the SAME solver at two maxiter values (one-time work is
identical in both programs), time each with the chained-dispatch
methodology, and report (T(hi) - T(lo)) / (hi - lo).

Usage: python benchmarks/hull_marginal.py {convexnmf|seminmf|chnmf|chcnmf}
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

import os

M = int(os.environ.get("HM_M", 100_000))
N = int(os.environ.get("HM_N", 10_000))
K = int(os.environ.get("HM_K", 200))
LO = int(os.environ.get("HM_LO", 10))
HI = int(os.environ.get("HM_HI", 40))
TRIALS = 4  # first discarded


def timed(call, chain0, tag):
    """call(chain_scalar) -> (result_state, fence_scalar); perturbs the
    init through `chain` so no two timed calls see the same input."""
    call(np.float32(1.0))  # warmup/compile
    dts = []
    f = np.float32(1.0)
    ent = np.random.default_rng()
    for _ in range(TRIALS):
        f = np.float32(1.0 + 1e-5 * ent.uniform(0.1, 1.0))
        t0 = time.perf_counter()
        fence = call(f)
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    med = sorted(dts)[len(dts) // 2]
    print(f"{tag}: {med:.3f} s (fence {fence:.4e})", flush=True)
    return med


def main():
    which = sys.argv[1]
    print(f"device: {jax.devices()[0]}", flush=True)
    kv, kw, kh, kg = jax.random.split(jax.random.PRNGKey(0), 4)
    V = jax.random.uniform(kv, (M, N), jnp.float32, 0.05, 1.0)
    H0 = jax.random.uniform(kh, (K, N), jnp.float32)
    jax.block_until_ready(V)
    tol = jnp.float32(1e-30)

    if which == "convexnmf":
        from nmf_toolbox_tpu.models.convexnmf import _build_solver, _Spec
        from nmf_toolbox_tpu.ops.gram import pos_neg_split
        G0 = jax.random.uniform(kg, (N, K), jnp.float32)
        gsp = jnp.asarray(0.0, jnp.float32)
        # One-time Gram outside the loop executable (the round-3
        # rematerialization fix); V here is uniform(0.05, 1) so the
        # nonneg specialization applies, matching the production path.
        VtV = V.T @ V
        v_sq = jnp.trace(VtV)
        grams = (VtV,)
        jax.block_until_ready(VtV)

        def make(maxiter):
            solve = _build_solver(_Spec(maxiter, False, False, None, True))
            def call(f):
                out = solve(grams, G0 * f, H0, v_sq, gsp, tol)
                return float(out.cost_buf[-1])
            return call
    elif which == "seminmf":
        from nmf_toolbox_tpu.models.seminmf import _build_solver, _Spec
        W0 = jax.random.uniform(kw, (M, K), jnp.float32, -1.0, 1.0)
        v_sq = jnp.sum(V * V)

        def make(maxiter):
            solve = _build_solver(_Spec(maxiter, False, False))
            def call(f):
                out = solve(V, W0 * f, H0, v_sq, tol)
                return float(out.cost_buf[-1])
            return call
    elif which in ("chnmf", "chcnmf"):
        # Hull extraction is one-time (measured separately in RESULTS);
        # here a synthetic hull basis S of p=500 columns of V stands in
        # so the loop cost is isolated.
        P = 500
        idx = jnp.arange(P) * (N // P)
        S = V[:, idx]
        G0 = jax.random.uniform(kg, (P, K), jnp.float32)
        zsp = jnp.asarray(0.0, jnp.float32)
        if which == "chnmf":
            from nmf_toolbox_tpu.core import EPS
            from nmf_toolbox_tpu.models.chnmf import _build_solver, _Spec
            # One-time hull Grams outside the loop executable (round-3
            # rematerialization fix): the loop never touches V again.
            StV = S.T @ V
            StS = S.T @ S
            v_sq = jnp.sum(V * V)
            jax.block_until_ready((StV, StS))

            def make(maxiter):
                solve = _build_solver(_Spec(maxiter, False, False, EPS))
                def call(f):
                    out = solve(StV, StS, G0 * f, H0, v_sq, zsp, zsp, tol)
                    return float(out.cost_buf[-1])
                return call
        else:
            from nmf_toolbox_tpu.core import EPS
            from nmf_toolbox_tpu.models.chcnmf import _build_solver, _Spec
            T = 8
            G0c = jax.random.uniform(kg, (P, K, T), jnp.float32)
            # one-time Grams (the loop never touches V again)
            V_sq = jnp.sum(V * V)
            StV = S.T @ V
            StS = S.T @ S
            jax.block_until_ready((StV, StS))

            def make(maxiter):
                solve = _build_solver(_Spec(T, maxiter, False, False, EPS))
                def call(f):
                    out = solve(V_sq, StV, StS, G0c * f, H0, zsp, zsp, tol)
                    return float(out.cost_buf[-1])
                return call
    else:
        raise SystemExit(f"unknown solver {which}")

    t_lo = timed(make(LO), None, f"{which} maxiter={LO}")
    t_hi = timed(make(HI), None, f"{which} maxiter={HI}")
    marginal_ms = (t_hi - t_lo) * 1e3 / (HI - LO)
    print(json.dumps({
        "solver": which, "shape": f"{M}x{N} r{K}",
        "t_lo_s": round(t_lo, 3), "t_hi_s": round(t_hi, 3),
        "marginal_ms_per_iter": round(marginal_ms, 3),
        "marginal_iters_per_sec": round(1e3 / marginal_ms, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
