"""cnmfsc steady-state perf at BASELINE #3.

Records MARGINAL ms/iter (net of per-call overhead and compile
amortization) by differencing two call lengths, and runs the
parallel-backtracking experiment: sequential halving vs
linesearch_width=8 batched trials.

Usage: python benchmarks/cnmfsc_marginal.py [--quick]
Writes benchmarks/CNMFSC_MARGINAL.json.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "CNMFSC_MARGINAL.json"


def main(quick: bool):
    import numpy as np
    import jax
    print("devices:", jax.devices(), flush=True)
    t0 = time.perf_counter()
    assert float(jax.jit(lambda x: (x * x).sum())(jax.numpy.ones((4, 4)))) == 16.0
    print(f"probe ok ({time.perf_counter() - t0:.0f}s)", flush=True)

    import nmf_toolbox_tpu as nt
    m, n, k, T = 513, 10_000 // (10 if quick else 1), 64, 8
    rng = np.random.default_rng(6)
    V = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (m, k, T)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    H0 = (H0 / np.sqrt((H0**2).sum(1, keepdims=True))).astype(np.float32)

    data = {}
    for label, extra in (("sequential", {}), ("batched_w8",
                                              {"linesearch_width": 8})):
        kw = dict(W_init=W0, H_init=H0, H_sparsity=0.5, tolerance=1e-30,
                  **extra)
        # warm both call lengths (distinct compiled programs: maxiter is
        # a static spec field)
        short_n, full_n = (2, 5) if quick else (20, 60)
        nt.cnmfsc(V, k, T, maxiter=short_n, **kw)
        t0 = time.perf_counter()
        nt.cnmfsc(V, k, T, maxiter=full_n, **kw)
        t_warm_full = time.perf_counter() - t0  # includes full-prog compile
        walls = {}
        for tag, it in (("short", short_n), ("full", full_n)):
            f = np.float32(np.random.default_rng(int(time.time() * 997) %
                                                 99991).uniform(0.9, 1.1))
            t0 = time.perf_counter()
            r = nt.cnmfsc(V, k, T, maxiter=it,
                          **{**kw, "W_init": W0 * f})
            walls[tag] = time.perf_counter() - t0
            c = np.asarray(r.cost)
            assert np.all(np.isfinite(c))
            print(f"{label} {tag}: {it} iters {walls[tag]:.2f}s "
                  f"({1000 * walls[tag] / it:.1f} ms/iter) final "
                  f"{float(c[-1]):.6g}", flush=True)
        marg = (walls["full"] - walls["short"]) / (full_n - short_n)
        data[label] = {
            "config": f"cnmfsc Hoyer(0.5) {m}x{n} r{k} T{T}",
            "device": str(jax.devices()[0]),
            "short_iters": short_n, "short_wall_s": round(walls["short"], 3),
            "full_iters": full_n, "full_wall_s": round(walls["full"], 3),
            "whole_call_ms_per_iter": round(1000 * walls["full"] / full_n, 2),
            "marginal_ms_per_iter": round(1000 * marg, 2),
            "warm_full_call_s": round(t_warm_full, 2),
        }
        print(label, "marginal:", data[label]["marginal_ms_per_iter"],
              "ms/iter", flush=True)
    # trajectory check: batched must track sequential (f32, same problem)
    a = np.asarray(nt.cnmfsc(V, k, T, W_init=W0, H_init=H0, H_sparsity=0.5,
                             tolerance=1e-30, maxiter=5).cost)
    b = np.asarray(nt.cnmfsc(V, k, T, W_init=W0, H_init=H0, H_sparsity=0.5,
                             tolerance=1e-30, maxiter=5,
                             linesearch_width=8).cost)
    rel = float(np.max(np.abs(a - b) / a))
    data["trajectory_max_rel_diff_seq_vs_batched"] = rel
    print("trajectory max rel diff:", rel, flush=True)
    OUT.write_text(json.dumps(data, indent=1))
    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    main(ap.parse_args().quick)
