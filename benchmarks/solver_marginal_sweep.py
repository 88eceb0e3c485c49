"""Marginal (steady-state) ms/iter for the solvers without a recorded
on-chip number: lnmf, constrainednmf, nmf2d, symnmf, and an ISOLATED
per-iteration device time for nmfsc under ``dispatch='phased'`` (the
whole-call time includes host round trips; this measures the
fused-iteration program itself, net of the boundary).

Methodology (benchmarks/naive_marginal.py): chained dispatches whose
inputs depend on the previous output (no host syncs between them),
>=100 iterations
per dispatch where the program's maxiter allows it, median of trials,
scalar host readback as the completion fence.  For nmfsc_phased the
program is ONE iteration per dispatch by design, so the marginal comes
from the slope between K=4 and K=32 chained enqueues:
(T32 - T4) / 28 removes the per-chain fence/round-trip constant.

Usage: python benchmarks/solver_marginal_sweep.py {lnmf|constrainednmf|nmf2d|symnmf|nmfsc_phased|all}
"""
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


def _shape(*dims):
    """Full benchmark shape, or /50 (min 8) under --small."""
    return tuple(max(8, d // 50) if SMALL else d for d in dims)


def time_chained(fn, args0, tag, iters=ITERS):
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
    ms = med * 1e3 / iters
    print(f"{tag}: {ms:.2f} ms/iter ({iters/med:.1f} iters/s) fence={f:.4e}",
          flush=True)
    return ms


def bench_lnmf(r):
    """lnmf.m:64-91 scale point: KL-class full-size V/V_hat ops."""
    from nmf_toolbox_tpu.models.lnmf import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    m, n, k = _shape(40_000, 10_000, 100)
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = jax.random.uniform(kw, (m, k), jnp.float32)
    H0 = jax.random.uniform(kh, (k, n), jnp.float32)
    jax.block_until_ready(V)
    solve = _build_solver(_Spec(ITERS, False, False, EPS))
    tol = jnp.float32(1e-30)

    def fn(W, H):
        out = solve(V, W, H, tol)
        return out.state, out.cost_buf
    r[f"lnmf_{m}_{n}_r{k}"] = time_chained(fn, (W0, H0),
                                           f"lnmf {m} x {n} r{k}")


def bench_constrainednmf(r):
    """constrainednmf.m:186-237 scale point: KL fields + label-block
    matmuls; 1/3 of the samples labeled across 10 classes."""
    from nmf_toolbox_tpu.models.constrainednmf import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    m, n, k, n_classes = (*_shape(40_000, 10_000, 100), 10)
    n_labeled = n // 3
    n_u = n - n_labeled
    kv, kw, kz = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = jax.random.uniform(kw, (m, k), jnp.float32)
    W0 = W0 / jnp.sqrt(jnp.sum(W0 * W0, axis=0))
    Z0 = jax.random.uniform(kz, (k, n_u + n_classes), jnp.float32)
    rng = np.random.default_rng(1)
    onehot = np.zeros((n_classes, n_labeled), np.float32)
    onehot[rng.integers(0, n_classes, n_labeled),
           np.arange(n_labeled)] = 1.0
    onehot = jnp.asarray(onehot)
    jax.block_until_ready(V)
    spec = _Spec("kl", 1.0, 1.0, ITERS, False, False, n_u, n_classes, EPS)
    solve = _build_solver(spec)
    zero = jnp.zeros((), jnp.float32)
    tol = jnp.float32(1e-30)

    def fn(W, Z):
        out = solve(V, W, Z, onehot, zero, zero, tol)
        return out.state, out.cost_buf
    r[f"constrainednmf_kl_{m}_{n}_r{k}"] = time_chained(
        fn, (W0, Z0), f"constrainednmf KL {m} x {n} r{k} (1/3 labeled)")


def bench_nmf2d(r):
    """nmf2d at the cnmf row's shape plus a 5-step pitch axis (the shift
    structure of cnmf.m:216-227 generalized to 2-D)."""
    from nmf_toolbox_tpu.models.nmf2d import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    m, n, k, T, P = (*_shape(513, 10_000, 64), 4 if SMALL else 8, 2 if SMALL else 5)
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = jax.random.uniform(kw, (m, k, T), jnp.float32)
    H0 = jax.random.uniform(kh, (k, n, P), jnp.float32)
    jax.block_until_ready(V)
    spec = _Spec("euclidean", 1.0, 1.0, T, P, ITERS, False, False, EPS)
    solve = _build_solver(spec)
    zeros = jnp.zeros((k,), jnp.float32)
    tol = jnp.float32(1e-30)

    def fn(W, H):
        out = solve(V, W, H, zeros, zeros, tol)
        return out.state, out.cost_buf
    r[f"nmf2d_{m}_{n}_r{k}_T{T}_P{P}"] = time_chained(
        fn, (W0, H0), f"nmf2d euclid {m} x {n} r{k} T{T} P{P}")


def bench_symnmf(r):
    """symnmf at a 10k-node similarity graph, r100: the (n, n) x (n, k)
    product dominates and runs once per iteration (carry trick)."""
    from nmf_toolbox_tpu.models.symnmf import _build_solver, _Spec
    from nmf_toolbox_tpu.core import EPS
    n, k = _shape(10_000, 100)
    ka, kh = jax.random.split(jax.random.PRNGKey(0), 2)
    B = jax.random.uniform(ka, (n, n), jnp.float32, 0.0, 1.0)
    A = (B + B.T) / 2
    H0 = jax.random.uniform(kh, (n, k), jnp.float32)
    jax.block_until_ready(A)
    solve = _build_solver(_Spec(ITERS, EPS))
    tol = jnp.float32(1e-30)

    def fn(H):
        out = solve(A, H, tol)
        return out.state[:1], out.cost_buf
    r[f"symnmf_{n}_r{k}"] = time_chained(fn, (H0,),
                                         f"symnmf {n} x {n} r{k}")


def bench_nmfsc_phased(r):
    """Isolated fused-iteration device time at BASELINE #2 (5000 x 2000
    r50, Hoyer(0.6) on H): K chained iter_step enqueues with one fence;
    the K=4 -> K=32 slope removes the per-chain boundary constant.
    The whole-call time includes ~1 host readback per iteration; this
    is the program itself."""
    from nmf_toolbox_tpu.models.nmfsc_phased import _build_phases, _PhSpec
    from nmf_toolbox_tpu.ops.projection import hoyer_l1_target
    from nmf_toolbox_tpu.core import EPS
    m, n, k = _shape(5000, 2000, 50)
    rng = np.random.default_rng(3)
    V = jnp.asarray(rng.uniform(0.1, 1.0, (m, n)).astype(np.float32))
    W = jnp.asarray(rng.uniform(size=(m, k)).astype(np.float32))
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    H = jnp.asarray(H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True)))
    l1_h = float(hoyer_l1_target(n, 0.6))
    spec = _PhSpec(w_sparse=False, h_sparse=True, w_fixed=False,
                   h_fixed=False, eps=EPS, l1_w=0.0, l1_h=l1_h,
                   trials=24, proj_passes=48)
    ph = _build_phases(spec)
    v_sq = ph["v_sq"](V)
    jax.block_until_ready(v_sq)
    step_w = jnp.float32(1.0)
    step_h = jnp.float32(1.0)

    def chain(K, Wc, Hc, sw, sh):
        t0 = time.perf_counter()
        flags = None
        for _ in range(K):
            Wc, Hc, sw, sh, flags = ph["iter"](V, Wc, Hc, sw, sh, v_sq)
        float(np.ravel(flags)[-1])  # scalar fence
        return time.perf_counter() - t0, (Wc, Hc, sw, sh)

    # warm compile + drain
    _, st = chain(2, W, H, step_w, step_h)
    jax.block_until_ready(st[0])
    best = None
    for _ in range(3):
        t4, st = chain(4, *st)
        t32, st = chain(32, *st)
        slope = (t32 - t4) / 28.0 * 1e3
        best = slope if best is None else min(best, slope)
        print(f"  nmfsc_phased chain: T4={t4*1e3:.1f} ms "
              f"T32={t32*1e3:.1f} ms -> {slope:.2f} ms/iter", flush=True)
    r[f"nmfsc_phased_marginal_{m}_{n}_r{k}"] = best
    print(f"nmfsc phased fused-iter marginal: {best:.2f} ms/iter",
          flush=True)


BENCHES = {"lnmf": bench_lnmf, "constrainednmf": bench_constrainednmf,
           "nmf2d": bench_nmf2d, "symnmf": bench_symnmf,
           "nmfsc_phased": bench_nmfsc_phased}


def main():
    # flags (--small, --cpu, ...) are scanned positionally-insensitively
    # elsewhere; the bench selector is the first NON-flag argument
    positional = [a for a in sys.argv[1:] if not a.startswith("-")]
    which = positional[0] if positional else "all"
    if which != "all" and which not in BENCHES:
        print(f"unknown bench {which!r}; choose from "
              f"{', '.join(BENCHES)} or 'all'", file=sys.stderr)
        return 2
    print(f"device: {jax.devices()[0]}", flush=True)
    r = {}
    names = list(BENCHES) if which == "all" else [which]
    for name in names:
        BENCHES[name](r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
