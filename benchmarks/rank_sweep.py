"""Fused multi-restart rank sweep vs dispatch-per-restart, on-chip.

Rank selection (rank.py) exists to answer "what k?" and its cost is the
cost of S restarts x R candidate ranks.  The naive shape of that
workload — S*R separate solver calls — pays the per-dispatch overhead
S*R times and underfills the matmul units at exploratory k.  The
framework's shape is one `nmf_multiseed` dispatch per rank (vmap over
inits, V shared in HBM).  This measures both at a typical exploratory
config and records the ratio.

Methodology: device-resident V uploaded once; every timed call fenced with a
scalar readback; first call per compiled shape discarded (compile); median
over repeats.  The sequential baseline uses the SAME euclid MU solver
(`nmf`, tolerance pinned so it runs all iterations) — this is a
dispatch-shape comparison, not a solver-quality one.

Usage: python benchmarks/rank_sweep.py [--quick] [--cpu]
Writes benchmarks/RANK_SWEEP.json (full accelerator runs only).
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "RANK_SWEEP.json"


def main(quick: bool, write: bool):
    import numpy as np
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    t0 = time.perf_counter()
    assert float(jax.jit(lambda x: (x * x).sum())(jnp.ones((4, 4)))) == 16.0
    print(f"probe ok ({time.perf_counter() - t0:.0f}s)", flush=True)

    import nmf_toolbox_tpu as nt

    if quick:
        m, n, S, iters, ranks, repeats = 500, 300, 8, 50, (4, 8), 2
    else:
        # Exploratory config: a song-length spectrogram, candidate ranks
        # around where practitioners actually search.
        m, n, S, iters, ranks, repeats = 2049, 4000, 16, 100, \
            (8, 16, 24, 32), 3

    rng = np.random.default_rng(0)
    Wt = rng.gamma(2.0, 1.0, (m, 12)).astype(np.float32)
    Ht = rng.gamma(0.5, 1.0, (12, n)).astype(np.float32)
    V = jnp.asarray(Wt @ Ht + 0.01)          # device-resident, uploaded once
    V.block_until_ready()

    def fence(res):
        # scalar host readback as the completion fence
        return float(np.asarray(res.cost)[..., -1].sum())

    def time_call(fn):
        t = time.perf_counter()
        fence(fn())
        return time.perf_counter() - t

    rows = {}
    for k in ranks:
        # --- fused: one dispatch for all S restarts ---
        fused = lambda: nt.nmf_multiseed(V, k, S, maxiter=iters, seed=1)
        time_call(fused)                      # compile, discarded
        t_fused = statistics.median(time_call(fused) for _ in range(repeats))

        # --- sequential: S dispatches of the single-matrix solver ---
        def seq():
            class R:  # aggregate last costs so the fence reads them all
                cost = np.stack([
                    np.asarray(nt.nmf(V, k, maxiter=iters, tolerance=1e-30,
                                      seed=100 + s).cost)
                    for s in range(S)])
            return R
        time_call(seq)                        # compile, discarded
        t_seq = statistics.median(time_call(seq) for _ in range(repeats))

        rows[k] = {"fused_s": round(t_fused, 4), "sequential_s": round(t_seq, 4),
                   "speedup": round(t_seq / t_fused, 2),
                   "fused_ms_per_restart": round(1e3 * t_fused / S, 2)}
        print(f"k={k}: fused {t_fused:.3f}s vs sequential {t_seq:.3f}s "
              f"({rows[k]['speedup']}x; {rows[k]['fused_ms_per_restart']} ms "
              f"per {iters}-iter restart)", flush=True)

    total_fused = sum(r["fused_s"] for r in rows.values())
    total_seq = sum(r["sequential_s"] for r in rows.values())
    out = {"config": {"m": m, "n": n, "n_seeds": S, "maxiter": iters,
                      "ranks": list(ranks), "repeats": repeats,
                      "quick": quick},
           "per_rank": rows,
           "sweep_total": {"fused_s": round(total_fused, 3),
                           "sequential_s": round(total_seq, 3),
                           "speedup": round(total_seq / total_fused, 2)},
           "device": str(jax.devices()[0])}
    print(json.dumps(out["sweep_total"]))
    if write:
        OUT.write_text(json.dumps(out, indent=1))
        print(f"wrote {OUT}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    main(args.quick, write=not (args.quick or args.cpu))
