"""Smoke test of the NMF solvers on one NVIDIA GPU.

Drives the public solver entry points once at the flagship width and
compares each result with a plain reference:

0. device: the default device must be a GPU; anything else exits 2
   before any phase runs.
1. flagship: ``nt.nmf`` Euclidean MU (Gram form) at 100k x 10k rank 200,
   20 iterations, against a plain jnp loop of nmf.m's naive updates run
   at ``"highest"`` matmul precision.
2. kl: ``nt.nmf(divergence="kl")`` (the naive divergence-field path) at
   40k x 10k rank 100 against the plain KL loop; then the same with
   ``method="fused"``, whose W phase is the Pallas/Triton kernel.
3. objective: BASELINE #1 (1000 x 500 rank 25, 200 iterations) in
   float32 on the card against a float64 NumPy transliteration of nmf.m.
4. encode: ``nt.nmf_encode`` KL at 256 problems of 257 x 400 rank 16
   against per-problem ``nt.nmf(..., W_fixed=True)``.
5. goldens: the 14 per-family golden trajectories (tests/goldens) in
   float32, and one sharded step per placement family on a 1-device
   mesh against the unsharded run.

``--four`` runs only the 4-card mesh phase: flagship ``nt.nmf`` and
``nt.cnmf`` (513 x 10k rank 64, T 8, halo exchange) on ``make_mesh()``
(1 x 4) and ``make_mesh(shape=(2, 2))``, each against one card, at the
default precision and at "highest".

Every check prints its deviation and tolerance.  A failed check or a
phase that raises makes the script exit 1.  The last line of standard
output is ``{"ok": true, "device": {...}}``, printed only when every
check passed.  Usage, from the root of a checkout:

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs, mesh phase only
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

GOLD = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
EPS = float(np.finfo(np.float64).eps)  # nmf.m's division guard

# Tolerances.  On the GPU a float32 matmul at the default precision runs
# on the TF32 tensor cores (10-bit mantissa operands, float32 sums), so
# the program and a "highest"-precision reference part by a few parts in
# 1e4 per product, and 20 multiplicative updates compound that.
TF32_COST = 1e-3     # relative, per iteration of the cost trace
TF32_FACTOR = 1e-2   # max |A - B| / max |B| over a factor
# The Gram-form Euclidean cost 0.5 (||V||^2 - 2<W'V, H> + <W'W, HH'>)
# cancels terms ~10x larger than the cost at this width, so the TF32
# error of <W'V, H> reaches the reported cost amplified: 5.5e-3 on an
# H100 at 100k x 10k r200.  The cost of the returned factors, computed
# at "highest", is held to TF32_COST all the same.
TF32_GRAM_COST = 2e-2
# Both at "highest": Gram form against naive form differs only in the
# association of float32 sums (the Gram cost identity cancels
# ||V||^2 against 2<W'V, H>, which leaves ~1e-6 of the cost).
F32_COST = 1e-4
F32_FACTOR = 1e-3
# North-star objective gate: within 1e-5 of the float64 oracle, at the
# program's default precision and at "highest".
OBJ_GATE = 1e-5
# Same program math on both sides (batched against per-problem, sharded
# against one card): only the order of float32 sums differs.
SAME_MATH_COST = 1e-4
SAME_MATH_FACTOR = 1e-3

FLAGSHIP = dict(m=100_000, n=10_000, k=200, iters=20)
KL = dict(m=40_000, n=10_000, k=100, iters=20)
OBJECTIVE = dict(m=1000, n=500, k=25, iters=200)
ENCODE = dict(B=256, m=257, n=400, k=16, iters=50)
CONV = dict(m=513, n=10_000, k=64, T=8, iters=20)


def check(name, dev, tol):
    ok = bool(np.isfinite(dev) and dev <= tol)
    print(f"  {name:<34} dev={dev:.3e}  tol={tol:.1e}  "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return ok


def rel_max(a, b):
    """max |a - b| / max |b| (complex-safe)."""
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rel_trace(c, ref):
    """Largest per-iteration relative deviation of a cost trace."""
    c = np.asarray(c, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    n = min(len(c), len(ref))
    return float(np.max(np.abs(c[:n] - ref[:n])
                        / np.maximum(np.abs(ref[:n]), 1e-300)))


def card_line():
    """``nvidia-smi``'s name and power limit of the cards, one per line."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return p.stdout.strip() or p.stderr.strip()


def final_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# Plain references: nmf.m's updates written out, independent of the package.
# ---------------------------------------------------------------------------

def _unit_cols(W):
    import jax.numpy as jnp
    return W / jnp.sqrt(jnp.sum(W * W, axis=0, keepdims=True))


def euclid_reference(V, W, H, iters):
    """nmf.m:147-203 Euclidean updates in naive form (explicit W @ H);
    returns (W, H, cost trace).  The caller sets the matmul precision."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(V, W, H):
        def body(i, c):
            W, H, costs = c
            Vh = W @ H
            neg = V @ H.T + W * jnp.diag(H @ Vh.T @ W)[None, :]
            pos = Vh @ H.T + W * jnp.diag(H @ V.T @ W)[None, :]
            W = _unit_cols(W * (neg / jnp.maximum(pos, EPS)))
            Vh = W @ H
            H = H * ((W.T @ V) / jnp.maximum(W.T @ Vh, EPS))
            return W, H, costs.at[i].set(euclid_cost(V, W, H))
        return jax.lax.fori_loop(0, iters, body,
                                 (_unit_cols(W), H,
                                  jnp.zeros((iters,), V.dtype)))
    return run(V, W, H)


def kl_reference(V, W, H, iters):
    """nmf.m:147-210 KL updates in naive form, with the explicit ones
    field; returns (W, H, cost trace)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(V, W, H):
        O = jnp.ones_like(V)

        def body(i, c):
            W, H, costs = c
            P = V / (W @ H)
            neg = P @ H.T + W * jnp.diag(H @ O.T @ W)[None, :]
            pos = O @ H.T + W * jnp.diag(H @ P.T @ W)[None, :]
            W = _unit_cols(W * (neg / jnp.maximum(pos, EPS)))
            H = H * ((W.T @ (V / (W @ H))) / jnp.maximum(W.T @ O, EPS))
            return W, H, costs.at[i].set(kl_cost(V, W, H))
        return jax.lax.fori_loop(0, iters, body,
                                 (_unit_cols(W), H,
                                  jnp.zeros((iters,), V.dtype)))
    return run(V, W, H)


def euclid_cost(V, W, H):
    import jax.numpy as jnp
    R = V - W @ H
    return 0.5 * jnp.sum(R * R)


def kl_cost(V, W, H):
    import jax.numpy as jnp
    Vh = W @ H
    return jnp.sum(V * jnp.log(V / Vh) - V + Vh)


def objective_oracle(V, W, H, iters):
    """Literal nmf.m:147-203 Euclidean updates in float64 NumPy."""
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


def _problem(seed, m, n, k, dtype=None):
    """Seeded uniform V in [0.05, 1) and uniform inits, made on device."""
    import jax
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(seed), 3)
    V = jax.random.uniform(kv, (m, n), dtype, 0.05, 1.0)
    W = jax.random.uniform(kw, (m, k), dtype, 0.1, 1.0)
    H = jax.random.uniform(kh, (k, n), dtype, 0.1, 1.0)
    return V, W, H


# ---------------------------------------------------------------------------
# Phases: each returns True when all of its checks passed.
# ---------------------------------------------------------------------------

def _factor_phase(tag, solves, reference, objective, m, n, k, iters, seed,
                  cost_tol=TF32_COST):
    """Each ``solves[label](V, W0, H0, iters)`` at the program's default
    precision and at "highest" against one "highest" reference run."""
    import jax
    V, W0, H0 = _problem(seed, m, n, k)
    with jax.default_matmul_precision("highest"):
        Wr, Hr, cr = reference(V, W0, H0, iters)
    Wr, Hr, cr = np.asarray(Wr), np.asarray(Hr), np.asarray(cr)
    ok = True
    for label, solve in solves.items():
        t = tag + label
        r = solve(V, W0, H0, iters)
        with jax.default_matmul_precision("highest"):
            c_fact = float(objective(V, r.W, r.H))
        ok &= check(f"{t}.n_iters", abs(r.n_iters - iters), 0)
        ok &= check(f"{t}.cost (default)", rel_trace(r.cost, cr), cost_tol)
        ok &= check(f"{t}.cost of factors (default)",
                    abs(c_fact - cr[-1]) / abs(cr[-1]), TF32_COST)
        ok &= check(f"{t}.W (default)", rel_max(r.W, Wr), TF32_FACTOR)
        ok &= check(f"{t}.H (default)", rel_max(r.H, Hr), TF32_FACTOR)
        with jax.default_matmul_precision("highest"):
            r = solve(V, W0, H0, iters)
        ok &= check(f"{t}.cost (highest)", rel_trace(r.cost, cr), F32_COST)
        ok &= check(f"{t}.W (highest)", rel_max(r.W, Wr), F32_FACTOR)
        ok &= check(f"{t}.H (highest)", rel_max(r.H, Hr), F32_FACTOR)
    return ok


def phase_flagship(m, n, k, iters, seed=0):
    import nmf_toolbox_tpu as nt

    def solve(V, W0, H0, iters):
        return nt.nmf(V, k, W_init=W0, H_init=H0, maxiter=iters,
                      tolerance=1e-30)
    return _factor_phase("flagship", {"": solve}, euclid_reference,
                         euclid_cost, m, n, k, iters, seed,
                         cost_tol=TF32_GRAM_COST)


def phase_kl(m, n, k, iters, seed=1):
    """The default naive path, and method="fused" (its W phase is the
    Pallas/Triton kernel, compiled for the card)."""
    import nmf_toolbox_tpu as nt

    def solver(method):
        def solve(V, W0, H0, iters):
            return nt.nmf(V, k, W_init=W0, H_init=H0, divergence="kl",
                          method=method, maxiter=iters, tolerance=1e-30)
        return solve
    return _factor_phase("kl", {"": solver("auto"),
                                ".fused": solver("fused")},
                         kl_reference, kl_cost, m, n, k, iters, seed)


def phase_objective(m, n, k, iters, seed=42):
    """bench.py's north-star gate (BASELINE #1)."""
    import jax
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    Wo, Ho = objective_oracle(V, W0.copy(), H0.copy(), iters)
    c_oracle = 0.5 * np.sum((V - Wo @ Ho) ** 2)

    def rel():
        r = nt.nmf(V.astype(np.float32), k, W_init=W0.astype(np.float32),
                   H_init=H0.astype(np.float32), maxiter=iters,
                   tolerance=1e-30)
        Wf, Hf = np.asarray(r.W, np.float64), np.asarray(r.H, np.float64)
        return abs(0.5 * np.sum((V - Wf @ Hf) ** 2) - c_oracle) / c_oracle
    ok = check("objective (default)", rel(), OBJ_GATE)
    with jax.default_matmul_precision("highest"):
        ok &= check("objective (highest)", rel(), OBJ_GATE)
    return ok


def phase_encode(B, m, n, k, iters, seed=2):
    import jax
    import nmf_toolbox_tpu as nt
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(seed), 3)
    Vs = jax.random.uniform(kv, (B, m, n), minval=0.05, maxval=1.0)
    W = jax.random.uniform(kw, (m, k), minval=0.1, maxval=1.0)
    H0 = jax.random.uniform(kh, (B, k, n), minval=0.1, maxval=1.0)
    res = nt.nmf_encode(Vs, W, H_init=H0, divergence="kl", maxiter=iters)
    Hs, costs = [], []
    for b in range(B):
        r = nt.nmf(Vs[b], k, W_init=W, W_fixed=True, H_init=H0[b],
                   divergence="kl", maxiter=iters, tolerance=1e-30)
        Hs.append(np.asarray(r.H))
        costs.append(rel_trace(np.asarray(res.cost)[b], r.cost))
    ok = check("encode.cost", max(costs), SAME_MATH_COST)
    ok &= check("encode.H", rel_max(res.H, np.stack(Hs)), SAME_MATH_FACTOR)
    return ok


def golden_cases(nt):
    """{name: (run, threshold)}; ``run()`` returns (result, golden dict).

    Thresholds are about 3x the worst deviation from the float64
    goldens among plain float32 on the CPU, float32 with every default-
    precision float32 dot rounded to TF32 operands on the CPU
    (utils/debug.emulate_tf32_matmul_numerics), and the run on an H100.
    The sparse (Hoyer) solvers run their line searches at "highest"
    precision, but a float32 step acceptance can still flip against the
    float64 golden, so their bounds stay at 3e-2.
    """
    f32 = np.float32

    def case(npz, fn, thresh):
        def run():
            g = dict(np.load(GOLD / npz))
            return fn(g), g
        return run, thresh

    C = {}
    C["nmf_kl"] = case("nmf_kl.npz", lambda g: nt.nmf(
        g["V"].astype(f32), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        divergence="kl", maxiter=20, tolerance=1e-12), 1e-3)
    C["nmf_weighted_kl"] = case("nmf_weighted_kl.npz", lambda g: nt.nmf(
        g["V"].astype(f32), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        weights=g["M"].astype(f32), divergence="kl", maxiter=15,
        tolerance=1e-12), 7e-4)
    C["cnmf_euclid"] = case("cnmf_euclid.npz", lambda g: nt.cnmf(
        g["V"].astype(f32), g["W0"].shape[1], g["W0"].shape[2],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        maxiter=15, tolerance=1e-12, method="gram"), 2e-3)
    C["lnmf"] = case("lnmf.npz", lambda g: nt.lnmf(
        g["V"].astype(f32), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        maxiter=15, tolerance=1e-12), 7e-4)
    C["seminmf"] = case("seminmf.npz", lambda g: nt.seminmf(
        g["V"].astype(f32), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        maxiter=15, tolerance=1e-12), 3.5e-3)
    C["convexnmf"] = case("convexnmf.npz", lambda g: nt.convexnmf(
        g["V"].astype(f32), g["G0"].shape[1],
        G_init=g["G0"].astype(f32), H_init=g["H0"].astype(f32),
        maxiter=15, tolerance=1e-12), 2e-3)
    C["chnmf"] = case("chnmf.npz", lambda g: nt.chnmf(
        g["V"].astype(f32), g["G0"].shape[1],
        S_init=g["S"].astype(f32), G_init=g["G0"].astype(f32),
        H_init=g["H0"].astype(f32), maxiter=15, tolerance=1e-12), 4e-3)
    C["chcnmf"] = case("chcnmf.npz", lambda g: nt.chcnmf(
        g["V"].astype(f32), g["G0"].shape[1], int(g["T"]),
        S_init=g["S"].astype(f32), G_init=g["G0"].astype(f32),
        H_init=g["H0"].astype(f32), H_sparsity=float(g["H_sparsity"]),
        maxiter=12, tolerance=1e-12), 3e-3)
    C["nmfsc_sparse"] = case("nmfsc_sparse.npz", lambda g: nt.nmfsc(
        g["V"].astype(f32), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        W_sparsity=0.5, H_sparsity=0.6, maxiter=12, tolerance=1e-12), 3e-2)
    C["cnmfsc_sparse"] = case("cnmfsc_sparse.npz", lambda g: nt.cnmfsc(
        g["V"].astype(f32), g["W0"].shape[1], int(g["T"]),
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        W_sparsity=float(g["W_sparsity"]), H_sparsity=float(g["H_sparsity"]),
        maxiter=10, tolerance=1e-12), 3e-2)
    C["cmfwisa"] = case("cmfwisa.npz", lambda g: nt.cmfwisa(
        g["V"].astype(np.complex64), g["W0"].shape[1],
        W_init=g["W0"].astype(f32), H_init=g["H0"].astype(f32),
        H_sparsity=float(g["H_sparsity"]), maxiter=15, tolerance=1e-12,
        dtype=np.complex64), 3e-3)
    C["constrainednmf_kl"] = case(
        "constrainednmf_kl.npz", lambda g: nt.constrainednmf(
            g["V"].astype(f32), g["labels"], g["W0"].shape[1],
            W_init=g["W0"].astype(f32), Z_init=g["Z0"].astype(f32),
            divergence="kl", maxiter=15, tolerance=1e-12), 1.5e-3)
    C["nmf2d_kl"] = case("nmf2d_kl.npz", lambda g: nt.nmf2d(
        g["V"].astype(f32), g["W0"].shape[1], g["W0"].shape[2],
        g["H0"].shape[2], W_init=g["W0"].astype(f32),
        H_init=g["H0"].astype(f32), divergence="kl", maxiter=15,
        tolerance=1e-12), 4e-4)
    C["symnmf"] = case("symnmf.npz", lambda g: nt.symnmf(
        g["A"].astype(f32), g["H0"].shape[1],
        H_init=g["H0"].astype(f32), maxiter=15, tolerance=1e-12), 7e-2)
    return C


FACTORS = ("W", "H", "G", "Z", "P")


def golden_deviation(run):
    """Largest relative deviation of a golden case's factors and cost."""
    r, g = run()
    devs = [rel_max(getattr(r, f), g[f]) for f in FACTORS
            if getattr(r, f, None) is not None and f in g]
    devs.append(rel_trace(r.cost, g["cost"]))
    return max(devs)


def sharded_steps(nt):
    """{name: fn(mesh)}: one step of each placement family."""
    rng = np.random.default_rng(0)
    m, n, k, T, P2 = 17, 29, 4, 3, 2
    V = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    W0c = rng.uniform(0.1, 1.0, (m, k, T)).astype(np.float32)
    Vc = (V * np.exp(1j * rng.uniform(size=(m, n)))).astype(np.complex64)
    S = V[:, rng.choice(n, 6, replace=False)].copy()
    G0c = rng.uniform(size=(6, k, 2)).astype(np.float32)
    Gn0 = rng.uniform(size=(n, k)).astype(np.float32)
    H2d0 = rng.uniform(size=(k, n, P2)).astype(np.float32)
    labels = np.full(n, -1)
    labels[rng.choice(n, 9, replace=False)] = rng.integers(0, 3, 9)
    Vb = rng.uniform(0.1, 1.0, (4, m, 11)).astype(np.float32)
    Asym = (V[:, :m] + V[:, :m].T) / 2
    one = dict(maxiter=1, tolerance=1e-12)
    return {
        "nmf": lambda mh: nt.nmf(V, k, W_init=W0, H_init=H0, mesh=mh, **one),
        "cnmf": lambda mh: nt.cnmf(V, k, T, W_init=W0c, H_init=H0, mesh=mh,
                                   **one),
        "cmfwisa": lambda mh: nt.cmfwisa(Vc, k, seed=1, mesh=mh, **one),
        "chcnmf": lambda mh: nt.chcnmf(V, k, 2, S_init=S, G_init=G0c,
                                       H_init=H0, mesh=mh, **one),
        "convexnmf": lambda mh: nt.convexnmf(V - 0.5, k, G_init=Gn0,
                                             H_init=H0, mesh=mh, **one),
        "constrainednmf": lambda mh: nt.constrainednmf(
            V, labels, k, W_init=W0, seed=1, mesh=mh, **one),
        "nmf2d": lambda mh: nt.nmf2d(V, k, T, P2, W_init=W0c, H_init=H2d0,
                                     mesh=mh, **one),
        "symnmf": lambda mh: nt.symnmf(Asym, k, seed=1, mesh=mh, **one),
        "nmf_encode": lambda mh: nt.nmf_encode(Vb, W0, maxiter=1, mesh=mh,
                                               seed=2),
    }


def sharded_deviation(fn, mesh):
    """Cost deviation of a sharded step from the same step unsharded."""
    c = np.asarray(fn(mesh).cost, np.float64).reshape(-1)
    c0 = np.asarray(fn(None).cost, np.float64).reshape(-1)
    if not np.all(np.isfinite(c)):
        return float("inf")
    return rel_trace(c, c0)


def phase_goldens(names=None):
    import jax
    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.parallel import make_mesh
    ok = True
    for name, (run, thresh) in golden_cases(nt).items():
        if names is None or name in names:
            ok &= check(f"golden.{name}", golden_deviation(run), thresh)
    mesh = make_mesh(1, devices=jax.devices()[:1])
    for name, fn in sharded_steps(nt).items():
        ok &= check(f"sharded1.{name}", sharded_deviation(fn, mesh),
                    SAME_MATH_COST)
    return ok


def phase_four(devices, flagship=FLAGSHIP, conv=CONV):
    """Flagship nmf and halo-exchange cnmf on a 1 x 4 and a 2 x 2 mesh,
    each against the same problem on one card: at "highest" (only the
    order of float32 sums differs) and at the default precision (the
    partitioned dots need not take the same TF32 path as one card's)."""
    import jax
    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.parallel import make_mesh
    meshes = {"1x4": make_mesh(devices=devices),
              "2x2": make_mesh(shape=(2, 2), devices=devices)}
    f, c = flagship, conv
    V, W0, H0 = _problem(0, f["m"], f["n"], f["k"])
    kw, kh = jax.random.split(jax.random.PRNGKey(3))
    Wc = jax.random.uniform(kw, (c["m"], c["k"], c["T"]), minval=0.1,
                            maxval=1.0)
    Hc = jax.random.uniform(kh, (c["k"], c["n"]), minval=0.1, maxval=1.0)
    Vc = _problem(4, c["m"], c["n"], 1)[0]
    runs = {
        "nmf": (lambda mesh: nt.nmf(V, f["k"], W_init=W0, H_init=H0,
                                    maxiter=f["iters"], tolerance=1e-30,
                                    mesh=mesh), TF32_GRAM_COST),
        "cnmf": (lambda mesh: nt.cnmf(Vc, c["k"], c["T"], W_init=Wc,
                                      H_init=Hc, maxiter=c["iters"],
                                      tolerance=1e-30, mesh=mesh), TF32_COST),
    }
    ok = True
    for name, (run, cost_tol) in runs.items():
        base = run(None)
        with jax.default_matmul_precision("highest"):
            base_hi = run(None)
        for label, mesh in meshes.items():
            t = f"four.{name}.{label}"
            r = run(mesh)
            ok &= check(f"{t}.cost (default)", rel_trace(r.cost, base.cost),
                        cost_tol)
            ok &= check(f"{t}.W (default)", rel_max(r.W, base.W), TF32_FACTOR)
            ok &= check(f"{t}.H (default)", rel_max(r.H, base.H), TF32_FACTOR)
            print(f"  {t}: default-precision cost vs one card at highest "
                  f"{rel_trace(r.cost, base_hi.cost):.3e}, one card's "
                  f"{rel_trace(base.cost, base_hi.cost):.3e}", flush=True)
            with jax.default_matmul_precision("highest"):
                r = run(mesh)
            ok &= check(f"{t}.cost (highest)",
                        rel_trace(r.cost, base_hi.cost), SAME_MATH_COST)
            ok &= check(f"{t}.W (highest)", rel_max(r.W, base_hi.W),
                        SAME_MATH_FACTOR)
            ok &= check(f"{t}.H (highest)", rel_max(r.H, base_hi.H),
                        SAME_MATH_FACTOR)
    return ok


def run_phases(phases):
    """Run ``[(name, fn), ...]``; returns True when every phase passed."""
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}", flush=True)
        try:
            passed = fn()
        except Exception:  # report and go on; the exit code says it failed
            traceback.print_exc()
            passed = False
        print(f"phase {name}: {'passed' if passed else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s wall, compile included)",
              flush=True)
        ok &= passed
    return ok


def select_phases(four, devices):
    if four:
        return [("four", lambda: phase_four(devices[:4]))]
    return [("flagship", lambda: phase_flagship(**FLAGSHIP)),
            ("kl", lambda: phase_kl(**KL)),
            ("objective", lambda: phase_objective(**OBJECTIVE)),
            ("encode", lambda: phase_encode(**ENCODE)),
            ("goldens", phase_goldens)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="NMF solver smoke test on GPU")
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs 4 GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    from nmf_toolbox_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")
    print(f"device: {devices[0].device_kind} x {len(devices)}")
    print(card_line(), flush=True)  # nvidia-smi's name, power limit
    if not run_phases(select_phases(args.four, devices)):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(final_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
