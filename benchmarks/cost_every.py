"""cost_every cadence: measured effect on the field-divergence hot loops.

The objective feeds only the stopping rule (nmf.m:221-224), so
``cost_every=N`` computes it on every Nth iteration and drops the
objective's (m, n) reconstruction + divergence pass (for KL: one matmul
plus a full log-field) from the other N-1.  This measures the actual
marginal-rate effect at the BASELINE shapes:

  * KL nmf (naive fields) 40k x 10k r100  — vs the 7.2 ms/iter row
  * weighted-KL nmf, same shape           — vs the 17.3 ms/iter row
  * nmf_encode KL, serving shape 256 x (257, 400) r16
                                          — vs the 0.52 ms/problem row
  * cnmf KL + euclid-gram 513 x 10k r64 T8 — BASELINE #3's shape (the
    KL objective pays a full T-shift reconstruction per iteration; the
    Gram objective pays the WW/HH cross-Gram recompute)
  * cnmf_encode KL B256 257x400 r16 T4    — the conv serving row

Chained-dispatch methodology (factors stay on device), ce in {1, 10}.

NOTE: the cnmf-KL rows' completion fence can read inf — after a few
hundred chained iterations on uniform-random data some V_hat entries
underflow to 0 in f32 and the REFERENCE-semantics unguarded objective
(V .* log(V ./ V_hat), nmf.m:210 / cnmf.m:239-248 — by design, an inf
cost just never fires the stop rule) saturates.  The readback still
fences completion; trajectory equality for cnmf is pinned by
tests/test_cost_every.py and the finite fences of the other rows.

Usage: python benchmarks/cost_every.py [--small]
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


def _dim(d):
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
    print(f"{tag}: {ms:.3f} ms/iter ({ITERS/med:.1f} iters/s) "
          f"fence={f:.4e}", flush=True)
    return ms


def main():
    print(f"device: {jax.devices()[0]}", flush=True)
    from nmf_toolbox_tpu.core import EPS
    from nmf_toolbox_tpu.models.nmf import _build_solver, _Spec
    r = {}

    m, n, k = _dim(40_000), _dim(10_000), _dim(100)
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W0 = jax.random.uniform(kw, (m, k), jnp.float32)
    H0 = jax.random.uniform(kh, (k, n), jnp.float32)
    Mw = (jax.random.uniform(jax.random.PRNGKey(9), (m, n))
          < 0.8).astype(jnp.float32)
    jax.block_until_ready((V, Mw))
    zeros = jnp.zeros((k,), jnp.float32)
    tol = jnp.float32(1e-30)

    for ce in (1, 10):
        spec = _Spec("kl", 1.0, 1.0, "naive", ITERS,
                     (False,), (False,), ((0, k),), EPS,
                     cost_every=ce)
        solve = _build_solver(spec)

        def fn(*state):
            out = solve(V, *state[:2], zeros, zeros, tol)
            return out.state, out.cost_buf
        r[f"kl_{m}_{n}_r{k}_ce{ce}"] = time_chained(
            fn, (W0, H0), f"KL nmf {m} x {n} r{k} cost_every={ce}")

        def fnw(*state):
            out = solve(V, *state[:2], zeros, zeros, tol, Mw)
            return out.state, out.cost_buf
        r[f"weighted_kl_{m}_{n}_r{k}_ce{ce}"] = time_chained(
            fnw, (W0, H0), f"weighted-KL nmf {m} x {n} r{k} cost_every={ce}")

    # serving encode (the batched_serving kl shape)
    import nmf_toolbox_tpu as nt
    B, em, en, ek = (16, 65, 100, 8) if SMALL else (256, 257, 400, 16)
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(1), 3)
    Vs = jax.random.uniform(kv, (B, em, en), jnp.float32, 0.05, 1.0)
    Wd = jax.random.uniform(kw, (em, ek), jnp.float32)
    H0s = jax.random.uniform(kh, (B, ek, en), jnp.float32)
    jax.block_until_ready(Vs)
    for ce in (1, 10):
        def enc(H):
            res = nt.nmf_encode(Vs, Wd, divergence="kl", H_init=H,
                                maxiter=ITERS, cost_every=ce,
                                device_output=True)
            return (res.H,), res.cost

        ms = time_chained(enc, (H0s,),
                          f"nmf_encode KL B{B} {em}x{en} r{ek} "
                          f"cost_every={ce}")
        r[f"encode_kl_B{B}_{em}_{en}_r{ek}_ce{ce}"] = ms
        # whole ITERS-iteration encode, per problem (the
        # batched_serving.py ms_per_problem_device basis)
        r[f"encode_kl_ms_per_problem_ce{ce}"] = ms * ITERS / B

    # convolutive training at BASELINE #3's shape (cnmf.m:175-251)
    from nmf_toolbox_tpu.models.cnmf import (_build_solver as _cnmf_solver,
                                             _Spec as _CSpec)
    cm, cn, ck, cT = _dim(513), _dim(10_000), _dim(64), 8 if not SMALL else 3
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(2), 3)
    Vc = jax.random.uniform(kv, (cm, cn), jnp.float32, 0.05, 1.0)
    Wc = jax.random.uniform(kw, (cm, ck, cT), jnp.float32)
    Hc = jax.random.uniform(kh, (ck, cn), jnp.float32)
    jax.block_until_ready(Vc)
    zc = jnp.zeros((ck,), jnp.float32)
    for div, method in (("kl", "naive"), ("euclidean", "gram")):
        for ce in (1, 10):
            spec = _CSpec(div, 1.0, 1.0, cT, ITERS, (False,), (False,),
                          ((0, ck),), EPS, method, None, ce)
            solve = _cnmf_solver(spec)

            def fnc(*state):
                out = solve(Vc, state[0], state[1], zc, zc, tol)
                return out.state[:2], out.cost_buf
            ms = time_chained(
                fnc, (Wc, Hc),
                f"cnmf {div}/{method} {cm} x {cn} r{ck} T{cT} "
                f"cost_every={ce}")
            r[f"cnmf_{div}_{cm}_{cn}_r{ck}_T{cT}_ce{ce}"] = ms

    # convolutive serving encode (batched_serving.py conv_encode shape)
    ceT = 4 if not SMALL else 2
    kw2 = jax.random.PRNGKey(3)
    Wcd = jax.random.uniform(kw2, (em, ek, ceT), jnp.float32)
    for ce in (1, 10):
        def cenc(H):
            res = nt.cnmf_encode(Vs, Wcd, divergence="kl", H_init=H,
                                 maxiter=ITERS, cost_every=ce,
                                 device_output=True)
            return (res.H,), res.cost

        ms = time_chained(cenc, (H0s,),
                          f"cnmf_encode KL B{B} {em}x{en} r{ek} T{ceT} "
                          f"cost_every={ce}")
        r[f"conv_encode_kl_B{B}_{em}_{en}_r{ek}_T{ceT}_ce{ce}"] = ms

    # 2-D deconvolutive training + serving encode: the objective is an
    # EXTRA full T*P-shift reconstruction per iteration in both (the
    # third for training, the second for encode), so the knob's ceiling
    # is ~1/3 resp. ~1/2 of per-iteration work (models/nmf2d.py,
    # models/batched.py _build_nmf2d_encode_solver)
    from nmf_toolbox_tpu.models.nmf2d import (_build_solver as _n2d_solver,
                                              _Spec as _N2dSpec)
    dP = 2 if SMALL else 5
    kw3, kh3 = jax.random.split(jax.random.PRNGKey(4))
    W2 = jax.random.uniform(kw3, (cm, ck, cT), jnp.float32)
    H2 = jax.random.uniform(kh3, (ck, cn, dP), jnp.float32)
    for ce in (1, 10):
        spec = _N2dSpec("kl", 1.0, 1.0, cT, dP, ITERS, False, False, EPS,
                        None, ce)
        solve = _n2d_solver(spec)

        def fn2(*state):
            out = solve(Vc, state[0], state[1], zc, zc, tol)
            return out.state[:2], out.cost_buf
        ms = time_chained(
            fn2, (W2, H2),
            f"nmf2d kl {cm} x {cn} r{ck} T{cT} P{dP} cost_every={ce}")
        r[f"nmf2d_kl_{cm}_{cn}_r{ck}_T{cT}_P{dP}_ce{ce}"] = ms

    W2d = jax.random.uniform(jax.random.PRNGKey(5), (em, ek, ceT),
                             jnp.float32)
    H02d = jax.random.uniform(jax.random.PRNGKey(6), (B, ek, en, dP),
                              jnp.float32)
    jax.block_until_ready((W2d, H02d))
    for ce in (1, 10):
        def enc2(H):
            res = nt.nmf2d_encode(Vs, W2d, dP, divergence="kl", H_init=H,
                                  maxiter=ITERS, cost_every=ce,
                                  device_output=True)
            return (res.H,), res.cost

        ms = time_chained(enc2, (H02d,),
                          f"nmf2d_encode KL B{B} {em}x{en} r{ek} T{ceT} "
                          f"P{dP} cost_every={ce}")
        r[f"nmf2d_encode_kl_B{B}_{em}_{en}_r{ek}_T{ceT}_P{dP}_ce{ce}"] = ms

    # lnmf at the marginal-sweep shape: the objective's V_hat = W @ H is
    # a THIRD full (m, k)x(k, n) matmul per iteration plus a log-field
    # pass, all of it stop-rule-only work (lnmf.m:83-88) — the knob's
    # ceiling is ~1/3 of the iteration (models/lnmf.py)
    from nmf_toolbox_tpu.models.lnmf import (_build_solver as _lnmf_solver,
                                             _Spec as _LSpec)
    from nmf_toolbox_tpu.ops.normalize import unit_sum_columns
    W0l = unit_sum_columns(W0)
    for ce in (1, 10):
        spec = _LSpec(ITERS, False, False, EPS, None, ce)
        solve = _lnmf_solver(spec)

        def fnl(*state):
            out = solve(V, state[0], state[1], tol)
            return out.state[:2], out.cost_buf
        r[f"lnmf_{m}_{n}_r{k}_ce{ce}"] = time_chained(
            fnl, (W0l, H0), f"lnmf {m} x {n} r{k} cost_every={ce}")

    # constrainednmf KL at the same shape (vs the 6.89 ms/iter marginal
    # row): the objective is one full KL divergence-field pass over the
    # (m, n) reconstruction (constrainednmf.m cost; models/constrainednmf.py)
    from nmf_toolbox_tpu.models.constrainednmf import (
        _build_solver as _cons_solver, _Spec as _ConsSpec)
    C = 10 if not SMALL else 3
    n_lab = n // 2
    n_u = n - n_lab
    lab = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (n_lab,),
                                        0, C))
    onehot = jnp.asarray(np.eye(C, dtype=np.float32)[lab].T)  # (C, n_lab)
    Z0c = jax.random.uniform(jax.random.PRNGKey(8), (k, n_u + C),
                             jnp.float32)
    zsc = jnp.float32(0.0)
    jax.block_until_ready((onehot, Z0c))
    for ce in (1, 10):
        spec = _ConsSpec("kl", 1.0, 1.0, ITERS, False, False, n_u, C,
                         EPS, None, ce)
        solve = _cons_solver(spec)

        def fncs(*state):
            out = solve(V, state[0], state[1], onehot, zsc, zsc, tol)
            return out.state[:2], out.cost_buf
        r[f"constrainednmf_kl_{m}_{n}_r{k}_ce{ce}"] = time_chained(
            fncs, (W0, Z0c),
            f"constrainednmf KL {m} x {n} r{k} cost_every={ce}")
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
