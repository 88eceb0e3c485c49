"""Steady-state (marginal) per-iteration cost of the Gram-family solvers
at BASELINE #5 scale (100k x 10k r200): convexnmf, seminmf, chnmf.

The round-1 RESULTS rows for these solvers are WHOLE-CALL figures over
10 iterations (234 / 152 ms/iter), dominated by one-time work the loop
never repeats.  Differencing whole calls (the cnmfsc methodology) turned
out to be too coarse here once the loops got cheap: the per-call fixed
overhead (factor readbacks, eager Gram dispatches) fluctuates between
calls, swamping a sub-5 ms/iter loop.

This version times the SOLVER EXECUTABLE directly: all operands are
device-resident (one-time Grams precomputed once, outside the timed
region — they are solver *arguments* since the round-3 rematerialization
fix), each timed dispatch is fenced with a scalar readback, successive
dispatches feed the previous output factors back as inputs (no host
syncs between them), and the marginal is the
median over repeats of (T(LONG) - T(SHORT)) / (LONG - SHORT) iterations.

Usage: python benchmarks/gram_family_marginal.py [--quick] [--cpu]
Writes benchmarks/GRAM_FAMILY_MARGINAL.json — only for a full-scale
accelerator run; --quick/--cpu smoke runs print the rows without
writing the measurement file.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "GRAM_FAMILY_MARGINAL.json"


def main(quick: bool):
    import numpy as np
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    t0 = time.perf_counter()
    assert float(jax.jit(lambda x: (x * x).sum())(jnp.ones((4, 4)))) == 16.0
    print(f"probe ok ({time.perf_counter() - t0:.0f}s)", flush=True)

    import importlib
    chn = importlib.import_module("nmf_toolbox_tpu.models.chnmf")
    cvx = importlib.import_module("nmf_toolbox_tpu.models.convexnmf")
    smn = importlib.import_module("nmf_toolbox_tpu.models.seminmf")

    if quick:
        m, n, k, p = 2000, 500, 16, 48
        short_n, long_n = 20, 60
        repeats = 2
    else:
        m, n, k, p = 100_000, 10_000, 200, 400
        short_n, long_n = 100, 400
        repeats = 3

    kv, kg, kh, kw, ks = jax.random.split(jax.random.PRNGKey(7), 5)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    G0 = jax.random.uniform(kg, (n, k), jnp.float32)          # convexnmf
    H0 = jax.random.uniform(kh, (k, n), jnp.float32)
    W0 = 2.0 * jax.random.uniform(kw, (m, k), jnp.float32) - 1.0  # seminmf
    S = V[:, :p]                                              # chnmf anchors
    Gp0 = jax.random.uniform(ks, (p, k), jnp.float32)
    jax.block_until_ready((V, G0, H0, W0, S, Gp0))

    tol = jnp.float32(1e-30)
    zero = jnp.float32(0.0)

    # -------- one-time device-resident operands (outside timed region)
    VtV = V.T @ V                      # convexnmf (nonneg V -> VV_neg = 0)
    v_sq_c = jnp.trace(VtV)
    StV = S.T @ V                      # chnmf
    StS = S.T @ S
    v_sq = jnp.sum(V * V)
    jax.block_until_ready((VtV, v_sq_c, StV, StS, v_sq))

    def fence(out):
        """Scalar host readback as the completion barrier."""
        return float(jnp.sum(out.state[0][:2, :2])) + float(out.cost_buf[0])

    def measure(label, build, args_for):
        """build(iters) -> compiled solve; args_for(iters, factors) -> args.
        factors evolve across dispatches (cache-defeating chaining)."""
        solves = {it: build(it) for it in (short_n, long_n)}
        state = None
        for it in (short_n, long_n):  # compile + first-dispatch warmup
            out = solves[it](*args_for(it, state))
            fence(out)
            state = out.state
        deltas, walls = [], {short_n: [], long_n: []}
        for r in range(repeats):
            t = {}
            for it in (short_n, long_n):
                t0 = time.perf_counter()
                out = solves[it](*args_for(it, state))
                fence(out)
                t[it] = time.perf_counter() - t0
                walls[it].append(t[it])
                state = out.state
            deltas.append((t[long_n] - t[short_n]) / (long_n - short_n))
            print(f"{label} r{r}: {short_n} it {t[short_n]:.3f}s | "
                  f"{long_n} it {t[long_n]:.3f}s -> "
                  f"{1000 * deltas[-1]:.2f} ms/iter", flush=True)
        marg = statistics.median(deltas)
        row = {
            "config": f"{label} {m}x{n} r{k}" + (f" p{p}"
                                                 if "chnmf" in label else ""),
            "device": str(jax.devices()[0]),
            "method": "direct-solve chained dispatches, scalar fence, "
                      f"median of {repeats} deltas",
            "short_iters": short_n, "long_iters": long_n,
            "short_wall_s": [round(x, 3) for x in walls[short_n]],
            "long_wall_s": [round(x, 3) for x in walls[long_n]],
            "marginal_ms_per_iter": round(1000 * marg, 3),
        }
        print(label, "marginal:", row["marginal_ms_per_iter"], "ms/iter",
              flush=True)
        return row

    data = {}
    data["seminmf"] = measure(
        "seminmf",
        lambda it: smn._build_solver(smn._Spec(it, False, False, None)),
        lambda it, st: (V, W0 if st is None else st[0],
                        H0 if st is None else st[1], v_sq, tol))
    data["chnmf"] = measure(
        "chnmf",
        lambda it: chn._build_solver(
            chn._Spec(it, False, False, float(np.finfo(np.float64).eps))),
        lambda it, st: (StV, StS, Gp0 if st is None else st[0],
                        H0 if st is None else st[1], v_sq, zero, zero, tol))
    data["convexnmf"] = measure(
        "convexnmf",
        lambda it: cvx._build_solver(cvx._Spec(it, False, False, None, True)),
        lambda it, st: ((VtV,), G0 if st is None else st[0],
                        H0 if st is None else st[1], v_sq_c, zero, tol))

    payload = json.dumps(data, indent=1) + "\n"
    on_accel = jax.devices()[0].platform != "cpu"
    if on_accel and not quick:
        OUT.write_text(payload)
        print("wrote", OUT, flush=True)
    else:
        # Smoke-test mode: never overwrite a full-scale measurement.
        print(payload, flush=True)
        print(f"smoke run (quick={quick}, platform="
              f"{jax.devices()[0].platform}); NOT writing {OUT}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    if a.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    main(a.quick)
