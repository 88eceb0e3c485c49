"""Headline benchmark: Euclidean NMF multiplicative updates at
100k x 10k rank-200 (BASELINE.json's metric) on the available device.

Prints ONE JSON line carrying BOTH halves of the BASELINE metric:

  {"metric": ..., "value": N, "unit": "iters/sec", "vs_baseline": N,
   "time_to_tol_s": ..., "tol_iters": ..., "tol_criterion": ...,
   "vs_matlab_time_to_tol": ..., "hals_time_to_tol_s": ...,
   "objective_rel_vs_oracle": ..., "objective_within_1e5": true}

vs_baseline is the speedup over single-core MATLAB running the reference
implementation (nmf.m) on the same problem.  The reference publishes no
numbers (BASELINE.md), so the MATLAB side is a documented FLOP-model
estimate:

  nmf.m euclidean iteration ~= 10 full-size matmuls (2 reconstructions of
  V_hat at nmf.m:173/203, four gradient products and two diag-correction
  chains at nmf.m:149-150, two H-gradient products at nmf.m:180-181)
  = ~20*m*n*k FLOPs = 4.0e12 at (m, n, k) = (1e5, 1e4, 200); a strong
  single MATLAB/BLAS core sustains ~5e10 FLOP/s in double precision
  -> ~80 s/iter -> 0.0125 iters/s.

Time-to-tolerance: MU on a full-rank random V converges to a stationary
point it cannot improve (a rank-200 model of a random 100k x 10k matrix
has ~0.46 irreducible relative error; "1e-4 reconstruction error" is
unreachable for ANY implementation of this algorithm), so the measurable
tolerance event is CONVERGENCE AT 1e-4 RELATIVE DECREASE: the first
iteration where (cost_prev - cost) / cost < 1e-4 * iters_in_chunk,
with the cost evaluated as a direct f32 residual 0.5||V - WH||^2 (the
Gram identity's f32 cancellation floor cannot certify this).  The MU
trajectory is implementation-independent, so MATLAB would need the SAME
iteration count: vs_matlab_time_to_tol = tol_iters * 80s / time_to_tol_s.

The objective check (north star "objective within 1e-5 relative"): the
float32 device run of BASELINE config #1 (1000x500 r25, 200 iters) is
compared with a float64 NumPy transliteration of nmf.m's update
equations, both objectives evaluated in f64 from the final factors.

Needs a GPU: without one it exits 2 and prints no result.  Everything
runs in this one process.
"""
import json
import sys
import time

import numpy as np

MATLAB_FLOPS_PER_SEC = 5e10   # strong single MATLAB/BLAS core (above);
# per-config estimate: MATLAB iters/s = MATLAB_FLOPS_PER_SEC / (20 m n k)
# = 0.0125 at the 100k x 10k r200 headline
REL_DECREASE_TOL = 1e-4


def _objective_check():
    """BASELINE config #1 parity: f32 device run vs f64 literal oracle."""
    import nmf_toolbox_tpu as nt

    rng = np.random.default_rng(42)
    V = rng.uniform(0.05, 1.0, (1000, 500))
    W0 = rng.uniform(size=(1000, 25))
    H0 = rng.uniform(size=(25, 500))
    EPS = np.finfo(np.float64).eps

    def oracle(V, W, H, iters):
        # literal nmf.m:147-203 euclidean updates in float64
        W = W / np.sqrt((W ** 2).sum(0, keepdims=True))
        for _ in range(iters):
            Vh = W @ H
            neg = V @ H.T + W * np.diag(H @ Vh.T @ W)[None, :]
            pos = Vh @ H.T + W * np.diag(H @ V.T @ W)[None, :]
            W = W * (neg / np.maximum(pos, EPS))
            W = W / np.sqrt((W ** 2).sum(0, keepdims=True))
            Vh = W @ H
            H = H * ((W.T @ V) / np.maximum(W.T @ Vh, EPS))
        return W, H

    Wo, Ho = oracle(V, W0.copy(), H0.copy(), 200)
    c_oracle = 0.5 * np.sum((V - Wo @ Ho) ** 2)
    r = nt.nmf(V.astype(np.float32), 25, W_init=W0.astype(np.float32),
               H_init=H0.astype(np.float32), maxiter=200, tolerance=1e-30)
    Wf, Hf = r.W.astype(np.float64), r.H.astype(np.float64)
    c_dev = 0.5 * np.sum((V - Wf @ Hf) ** 2)
    rel = abs(c_dev - c_oracle) / c_oracle
    return {"objective_rel_vs_oracle": rel,
            "objective_within_1e5": bool(rel <= 1e-5)}


def _hals_tol():
    """HALS (the framework's best euclidean solver) time-to-tolerance at
    the headline scale, factors kept on device between chunks.  Also
    reports the NNDSVD-seeded run (utils/init.nndsvd), whose clock
    INCLUDES the randomized-SVD seeding."""
    import jax
    import jax.numpy as jnp
    from nmf_toolbox_tpu.models.hals import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    from nmf_toolbox_tpu.utils.init import nndsvd

    m, n, k = 100_000, 10_000, 200
    chunk = 20
    kv, kw, kh, ks = jax.random.split(jax.random.PRNGKey(0), 4)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = jax.random.uniform(kw, (m, k), jnp.float32)
    H0 = jax.random.uniform(kh, (k, n), jnp.float32)
    jax.block_until_ready(V)

    solve = _build_solver(_Spec(chunk, k, EPS))
    tol = jnp.float32(1e-30)

    @jax.jit
    def direct_cost(V, W, H):
        E = V - jax.lax.dot(W, H, preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(E * E)

    out = solve(V, W0, H0, tol)  # warmup compile
    float(direct_cost(V, *out.state))

    def run_to_tol(W, H, seeded: bool):
        if seeded:
            # warm the seeding compile outside the clock; the timed run
            # still pays the seeding execution
            jax.block_until_ready(nndsvd(V, k, key=jax.random.PRNGKey(9)))
        t0 = time.perf_counter()
        if seeded:
            W, H = nndsvd(V, k, key=ks)
            jax.block_until_ready((W, H))
        c_prev, iters = None, 0
        for _ in range(30):  # cap at 600 iterations
            out = solve(V, W, H, tol)
            W, H = out.state
            iters += chunk
            c = float(direct_cost(V, W, H))
            if c_prev is not None and \
                    (c_prev - c) / c < REL_DECREASE_TOL * chunk:
                break
            c_prev = c
        return time.perf_counter() - t0, iters

    dt, iters = run_to_tol(W0, H0, seeded=False)
    dt2, iters2 = run_to_tol(None, None, seeded=True)
    return {"hals_time_to_tol_s": round(dt, 3), "hals_tol_iters": iters,
            "hals_nndsvd_time_to_tol_s": round(dt2, 3),
            "hals_nndsvd_tol_iters": iters2}


def _accel_tol():
    """Accelerated MU (inner_iters=4; Gillis & Glineur) time-to-tolerance
    at the headline scale — the MU family's best time-to-tol setting."""
    import jax
    import jax.numpy as jnp
    from nmf_toolbox_tpu.models.nmf import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    from nmf_toolbox_tpu.ops.normalize import unit_l2_columns

    m, n, k = 100_000, 10_000, 200
    chunk, inner = 10, 4
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W = unit_l2_columns(jax.random.uniform(kw, (m, k), jnp.float32))
    H = jax.random.uniform(kh, (k, n), jnp.float32)
    jax.block_until_ready(V)

    spec = _Spec("euclidean", 1.0, 1.0, "gram", chunk,
                 (False,), (False,), ((0, k),), EPS, None, None, inner)
    solve = _build_solver(spec)
    zeros = jnp.zeros((k,), jnp.float32)
    tol = jnp.float32(1e-30)

    @jax.jit
    def direct_cost(V, W, H):
        E = V - jax.lax.dot(W, H, preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(E * E)

    out = solve(V, W, H, zeros, zeros, tol)  # warmup compile
    float(direct_cost(V, *out.state))

    t0 = time.perf_counter()
    c_prev, iters = None, 0
    for _ in range(60):  # cap at 600 outer iterations
        out = solve(V, W, H, zeros, zeros, tol)
        W, H = out.state
        iters += chunk
        c = float(direct_cost(V, W, H))
        if c_prev is not None and (c_prev - c) / c < REL_DECREASE_TOL * chunk:
            break
        c_prev = c
    dt = time.perf_counter() - t0
    return {"mu_accel_time_to_tol_s": round(dt, 3),
            "mu_accel_tol_iters": iters, "mu_accel_inner_iters": inner}


def _nmfsc_b2():
    """BASELINE #2 sparse config: full 30-iteration nmfsc Hoyer(0.6)
    5000x2000 r50 via dispatch='phased' (fused-iteration programs +
    speculative block dispatch), device-resident V."""
    import jax
    import jax.numpy as jnp
    import nmf_toolbox_tpu as nt

    rng = np.random.default_rng(3)
    m, n, k = 5000, 2000, 50
    V = jnp.asarray(rng.uniform(0.1, 1.0, (m, n)).astype(np.float32))
    W0 = jnp.asarray(rng.uniform(size=(m, k)).astype(np.float32))
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    H0 = jnp.asarray(H0 / np.sqrt((H0**2).sum(1, keepdims=True)))
    jax.block_until_ready(V)
    kw = dict(H_sparsity=0.6, tolerance=1e-30, dispatch="phased")
    nt.nmfsc(V, k, W_init=W0, H_init=H0, maxiter=2, **kw)  # warm compile
    best = None
    for trial in range(2):
        f = jnp.float32(1.0 + 1e-5 * np.random.default_rng().uniform(0.1, 1.0))
        t0 = time.perf_counter()
        r = nt.nmfsc(V, k, W_init=W0 * f, H_init=H0, maxiter=30, **kw)
        dt = time.perf_counter() - t0
        c = np.asarray(r.cost)
        assert r.n_iters == 30 and np.all(np.isfinite(c))
        best = dt if best is None else min(best, dt)
    return {"nmfsc_b2_wall_s": round(best, 3),
            "nmfsc_b2_ms_per_iter": round(1000 * best / 30, 2),
            "nmfsc_b2_final_cost": float(c[-1])}


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp
    from nmf_toolbox_tpu.models.nmf import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    from nmf_toolbox_tpu.ops.normalize import unit_l2_columns
    from nmf_toolbox_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(f"device: {dev.device_kind}", file=sys.stderr)

    m, n, k = 100_000, 10_000, 200
    # 100 iterations per dispatch amortise the per-dispatch overhead;
    # production solves run far longer dispatches.
    timing_iters = 100
    key = jax.random.PRNGKey(0)
    kv, kw, kh = jax.random.split(key, 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = unit_l2_columns(jax.random.uniform(kw, (m, k), jnp.float32))
    H0 = jax.random.uniform(kh, (k, n), jnp.float32)
    jax.block_until_ready(V)

    spec = _Spec("euclidean", 1.0, 1.0, "gram", timing_iters,
                 (False,), (False,), ((0, k),), EPS)
    solve = _build_solver(spec)
    zeros = jnp.zeros((k,), jnp.float32)
    tol = jnp.float32(1e-30)  # never triggers: time all iterations

    @jax.jit
    def direct_cost(V, W, H):
        # direct f32 residual: the Gram identity's cancellation
        # floor (~v_sq * eps_f32) cannot resolve the tolerance event
        E = V - jax.lax.dot(W, H, preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(E * E)

    # Warmup (compile + one full run of both programs).
    out = solve(V, W0, H0, zeros, zeros, tol)
    jax.block_until_ready(out.cost_buf)
    float(direct_cost(V, out.state[0], out.state[1]))

    # --- Phase 1: iters/sec ------------------------------------------
    # Each trial starts from a slightly perturbed init; the first trial
    # is discarded and the median of the rest is kept.
    ent = np.random.default_rng()
    dts = []
    for trial in range(4):
        W0t = W0 * np.float32(1.0 + 1e-5 * ent.uniform(0.1, 1.0))
        jax.block_until_ready(W0t)
        t0 = time.perf_counter()
        out = solve(V, W0t, H0, zeros, zeros, tol)
        jax.block_until_ready(out.cost_buf)
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    dt = sorted(dts)[len(dts) // 2]
    iters_per_sec = timing_iters / dt
    c = np.asarray(out.cost_buf)
    print(f"config {m}x{n} r{k}: {iters_per_sec:.2f} iters/s "
          f"({dt*1e3/timing_iters:.1f} ms/iter), cost {c[0]:.3e} -> {c[-1]:.3e}",
          file=sys.stderr)

    # --- Phase 2: time to 1e-4 relative decrease ----------------------
    # Chunked on the same compiled program; factors stay on device.
    W0t = W0 * np.float32(1.0 + 1e-5 * ent.uniform(0.1, 1.0))
    jax.block_until_ready(W0t)
    t0 = time.perf_counter()
    Wd, Hd = W0t, H0
    c_prev, tol_iters = None, 0
    for _ in range(30):  # cap at 3000 iterations
        out = solve(V, Wd, Hd, zeros, zeros, tol)
        Wd, Hd = out.state
        tol_iters += timing_iters
        cc = float(direct_cost(V, Wd, Hd))
        if c_prev is not None and \
                (c_prev - cc) / cc < REL_DECREASE_TOL * timing_iters:
            break
        c_prev = cc
    time_to_tol = time.perf_counter() - t0
    v_sq = float(jnp.sum(V * V))
    rel_err = (2.0 * cc / v_sq) ** 0.5
    print(f"time-to-tol (1e-4 rel decrease): {time_to_tol:.2f}s over "
          f"{tol_iters} iters (rel recon err {rel_err:.4f})",
          file=sys.stderr)
    del V, W0, H0, Wd, Hd, out

    matlab_ips = MATLAB_FLOPS_PER_SEC / (20.0 * m * n * k)
    result = {
        "metric": f"euclidean NMF MU iters/sec, {m}x{n} rank-{k}, f32, "
                  f"1 {dev.device_kind}",
        "value": round(iters_per_sec, 3),
        "unit": "iters/sec",
        "vs_baseline": round(iters_per_sec / matlab_ips, 1),
        "time_to_tol_s": round(time_to_tol, 3),
        "tol_iters": tol_iters,
        "tol_criterion": "first iter with relative objective "
                         "decrease < 1e-4 (direct f32 residual)",
        "rel_recon_err_at_tol": round(rel_err, 5),
        "vs_matlab_time_to_tol": round(
            tol_iters / matlab_ips / time_to_tol, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    result.update(_hals_tol())
    result.update(_accel_tol())
    result.update(_objective_check())
    result.update(_nmfsc_b2())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
