"""Benchmark harness: the five BASELINE.json configs.

Each config reports MU iterations/second (median of 3 trials after a
warmup/compile run; each trial starts from a slightly perturbed init and
the first is discarded).  Emits one JSON object per config and a summary
file.

Usage:
    python benchmarks/run_all.py [--quick] [--out report.json] [--only NAME]

--quick shrinks every config ~8x (CPU-runnable smoke mode).
"""
from __future__ import annotations

# repo root on sys.path: these scripts run as 'python benchmarks/x.py'
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import argparse
import json
import sys
import time

import numpy as np


def _timed_iters(call, make_init, iters):
    import jax
    ent = np.random.default_rng()
    call(make_init(np.float32(1.0)))  # warmup/compile
    ts = []
    for _ in range(4):
        W0t = make_init(np.float32(1.0 + 1e-5 * ent.uniform(0.1, 1.0)))
        jax.block_until_ready(W0t)
        t0 = time.perf_counter()
        call(W0t)
        ts.append(time.perf_counter() - t0)
    med = sorted(ts[1:])[1]
    return iters / med


def _timed_chunked(solve_chunk, state0, chunk, n_chunks):
    """Time `n_chunks` dispatches of a `chunk`-iteration compiled solver,
    threading DEVICE-RESIDENT state between dispatches.

    The first (post-warmup) dispatch is discarded, matching
    _timed_iters.
    """
    import jax

    def fence(state):
        jax.block_until_ready(state)
        float(jax.numpy.ravel(state[0])[0])

    state = solve_chunk(state0)  # warmup/compile dispatch
    fence(state)
    state = solve_chunk(state)   # discarded
    fence(state)
    ts = []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        state = solve_chunk(state)
        fence(state)
        ts.append(time.perf_counter() - t0)
    med = sorted(ts)[len(ts) // 2]
    return chunk / med, (1 + n_chunks) * chunk  # iters/s, iters executed


CONFIG_NAMES = ["nmf-euclid", "nmf-kl", "nmfsc", "cnmf", "cnmfsc",
                "cmfwisa", "convexnmf", "seminmf"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None, choices=CONFIG_NAMES,
                    help="run a single config")
    args = ap.parse_args()

    import jax
    if args.quick:
        # smoke mode runs on the CPU
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import nmf_toolbox_tpu as nt

    q = 8 if args.quick else 1
    iters = 10 if args.quick else 30
    results = []

    def record(name, value, extra=None):
        row = {"config": name, "iters_per_sec": round(value, 2),
               "ms_per_iter": round(1e3 / value, 3)}
        row.update(extra or {})
        results.append(row)
        print(json.dumps(row), file=sys.stderr)

    def rnd(key, shape, lo=0.05, hi=1.0):
        return jax.random.uniform(jax.random.PRNGKey(key), shape,
                                  jnp.float32, lo, hi)

    def want(name):
        return args.only is None or args.only == name

    # 1) nmf euclidean 1000x500 r25 (PR1 reference config, CPU-runnable)
    m, n, k = (1000, 500, 25) if not args.quick else (225, 112, 25)
    if want("nmf-euclid"):
        V, H0 = rnd(0, (m, n)), rnd(2, (k, n))
        W0 = rnd(1, (m, k))
        ips = _timed_iters(
            lambda W: nt.nmf(V, k, W_init=W, H_init=H0, maxiter=iters,
                             tolerance=1e-30),
            lambda f: W0 * f, iters)
        record(f"nmf euclidean {m}x{n} r{k}", ips)

    # 2) KL nmf + Hoyer nmfsc 5000x2000 r50
    m, n, k = 5000 // q, 2000 // q, 50
    if want("nmf-kl") or want("nmfsc"):
        V, W0, H0 = rnd(3, (m, n)), rnd(4, (m, k)), rnd(5, (k, n))
        if want("nmf-kl"):
            ips = _timed_iters(
                lambda W: nt.nmf(V, k, W_init=W, H_init=H0, divergence="kl",
                                 maxiter=iters, tolerance=1e-30),
                lambda f: W0 * f, iters)
            record(f"nmf KL {m}x{n} r{k}", ips)
        if want("nmfsc"):
            H0n = H0 / jnp.sqrt(jnp.sum(H0 * H0, axis=1, keepdims=True))
            if args.quick:
                ips = _timed_iters(
                    lambda W: nt.nmfsc(V, k, W_init=W, H_init=H0n,
                                       H_sparsity=0.6, maxiter=iters,
                                       tolerance=1e-30),
                    lambda f: W0 * f, iters)
                total = iters
            else:
                # Full size: chunked dispatch, device-resident state
                # between chunks, stepsize-exact carry.
                import jax
                from nmf_toolbox_tpu.models.nmfsc import (
                    _build_solver as _nmfsc_build, _Spec as _NmfscSpec)
                from nmf_toolbox_tpu.ops.projection import hoyer_l1_target
                from nmf_toolbox_tpu.core import EPS
                chunk = 5
                spec = _NmfscSpec(chunk, False, True, False, False, EPS,
                                  0.0, float(hoyer_l1_target(n, 0.6)))
                solve = _nmfsc_build(spec)
                Vn = V / jnp.max(V)  # wrapper semantics (nmfsc.m:62)
                tol = jnp.float32(1e-30)
                one = jnp.float32(1.0)

                def solve_chunk(state):
                    with jax.default_matmul_precision("highest"):
                        return solve(Vn, state[0], state[1], tol,
                                     state[2], state[3]).state

                ips, total = _timed_chunked(solve_chunk,
                                            (W0, H0n, one, one), chunk, 2)
            record(f"nmfsc Hoyer(0.6) {m}x{n} r{k}", ips,
                   {"iters_executed": total})

    # 3) cnmf / cnmfsc on a 513 x 10k STFT-shaped matrix, T=8
    m, n, k, T = 513, 10_000 // q, 64, 8
    if want("cnmf") or want("cnmfsc"):
        V, W0, H0 = rnd(6, (m, n)), rnd(7, (m, k, T)), rnd(8, (k, n))
        if want("cnmf"):
            ips = _timed_iters(
                lambda W: nt.cnmf(V, k, T, W_init=W, H_init=H0, maxiter=iters,
                                  tolerance=1e-30),
                lambda f: W0 * f, iters)
            record(f"cnmf euclid-gram {m}x{n} r{k} T{T}", ips)
        if want("cnmfsc"):
            H0n = H0 / jnp.sqrt(jnp.sum(H0 * H0, axis=1, keepdims=True))
            ips = _timed_iters(
                lambda W: nt.cnmfsc(V, k, T, W_init=W, H_init=H0n,
                                    H_sparsity=0.5, maxiter=iters,
                                    tolerance=1e-30),
                lambda f: W0 * f, iters)
            record(f"cnmfsc Hoyer(0.5) {m}x{n} r{k} T{T}", ips)

    # 4) cmfwisa complex64 spectrograms
    m, n, k = 513, 5000 // q, 32
    if want("cmfwisa"):
        mag = rnd(9, (m, n))
        ph = jax.random.uniform(jax.random.PRNGKey(10), (m, n), jnp.float32,
                                -np.pi, np.pi)
        W0, H0 = rnd(11, (m, k)), rnd(12, (k, n))
        if args.quick:
            Vc = (mag * jnp.exp(1j * ph)).astype(jnp.complex64)
            ips = _timed_iters(
                lambda W: nt.cmfwisa(Vc, k, W_init=W, H_init=H0, maxiter=iters,
                                     tolerance=1e-30),
                lambda f: W0 * f, iters)
            total = iters
        else:
            # Full size: chunked dispatch on the internal solver; the
            # complex data/phase stay on device as real planes.
            from nmf_toolbox_tpu.models.cmfwisa import (
                _build_solver as _cm_build, _Spec as _CmSpec)
            from nmf_toolbox_tpu.core import EPS
            chunk = 10
            spec = _CmSpec(chunk, (False,), (False,), (False,),
                           ((0, k),), EPS)
            solve = _cm_build(spec)
            V_re = mag * jnp.cos(ph)
            V_im = mag * jnp.sin(ph)
            # P0 = exp(1j angle(V)): planes cos(ph), sin(ph)
            P_re0 = jnp.cos(ph)[None]
            P_im0 = jnp.sin(ph)[None]
            hsp = jnp.zeros((k,), jnp.float32)
            tol = jnp.float32(1e-30)

            def solve_chunk(state):
                W, H, P_re, P_im = state
                return solve(V_re, V_im, W, H, P_re, P_im, hsp, tol).state

            ips, total = _timed_chunked(
                solve_chunk, (W0, H0, P_re0, P_im0), chunk, 2)
        record(f"cmfwisa complex64 {m}x{n} r{k}", ips,
               {"iters_executed": total})

    # 5) hull family at scale: convexnmf/seminmf (n x n Gram regime)
    m, n, k = 100_000 // q, 10_000 // q, 200
    if want("convexnmf") or want("seminmf"):
        V = rnd(13, (m, n))
        H0 = rnd(15, (k, n))
        if want("convexnmf"):
            G0 = rnd(14, (n, k))
            ips = _timed_iters(
                lambda G: nt.convexnmf(V, k, G_init=G, H_init=H0,
                                       maxiter=iters, tolerance=1e-30),
                lambda f: G0 * f, iters)
            record(f"convexnmf {m}x{n} r{k}", ips)
        if want("seminmf"):
            W0 = jax.random.uniform(jax.random.PRNGKey(16), (m, k),
                                    jnp.float32, -1, 1)
            ips = _timed_iters(
                lambda W: nt.seminmf(V, k, W_init=W, H_init=H0,
                                     maxiter=iters, tolerance=1e-30),
                lambda f: W0 * f, iters)
            record(f"seminmf {m}x{n} r{k}", ips)

    out = {"device": str(jax.devices()[0]), "quick": args.quick,
           "results": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()
