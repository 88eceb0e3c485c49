"""Full-size nmfsc on the accelerator via the phase-split dispatch.

BASELINE #2 (5000x2000 r50): dispatch='phased' (models/nmfsc_phased.py)
keeps every device program short and statically bounded, so the full
30-iteration run can execute as ~5 small dispatches per iteration.

Usage:  python benchmarks/nmfsc_phased.py --stage {probe,small,mid,full}
Each stage runs in its own process; `--stage cpu-ref`
computes the CPU reference trajectory for the full shape (f32) for the
parity check.  Writes/updates benchmarks/NMFSC_PHASED.json.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))  # repo root (script dir is benchmarks/)
OUT = HERE / "NMFSC_PHASED.json"


def problem(m, n, k, dtype="float32"):
    import numpy as np
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1.0, (m, n)).astype(dtype)
    W0 = rng.uniform(size=(m, k)).astype(dtype)
    H0 = rng.uniform(size=(k, n)).astype(dtype)
    H0 = (H0 / np.sqrt((H0**2).sum(1, keepdims=True))).astype(dtype)
    return V, W0, H0


def run_stage(m, n, k, iters, label):
    import numpy as np
    import jax
    print("devices:", jax.devices(), flush=True)
    # tiny probe first: a compile-and-run check before the real shapes
    t0 = time.perf_counter()
    probe = float(jax.jit(lambda x: (x * x).sum())(jax.numpy.ones((8, 8))))
    assert probe == 64.0
    print(f"probe jit ok ({time.perf_counter() - t0:.1f}s)", flush=True)

    import nmf_toolbox_tpu as nt
    V, W0, H0 = problem(m, n, k)
    kw = dict(H_sparsity=0.6, tolerance=1e-30, dispatch="phased")

    # warm the phase programs (compile) on a 2-iteration call
    t0 = time.perf_counter()
    r = nt.nmfsc(V, k, W_init=W0, H_init=H0, maxiter=2, **kw)
    t_warm = time.perf_counter() - t0
    print(f"{label}: warm 2-iter call {t_warm:.1f}s, cost "
          f"{np.asarray(r.cost).tolist()}", flush=True)

    # timed short call and timed full call; entropy-scale the init per
    # call so no two timed dispatches see the same input
    results = {}
    for tag, it in (("short", max(iters // 3, 2)), ("full", iters)):
        f = np.float32(np.random.default_rng(int(time.time()) % 100000)
                       .uniform(0.9, 1.1))
        t0 = time.perf_counter()
        r = nt.nmfsc(V, k, W_init=W0 * f, H_init=H0, maxiter=it, **kw)
        wall = time.perf_counter() - t0
        c = np.asarray(r.cost)
        assert np.all(np.isfinite(c)), "non-finite cost"
        assert r.n_iters == it, (r.n_iters, it)
        results[tag] = dict(iters=it, wall_s=round(wall, 3),
                            ms_per_iter=round(1000 * wall / it, 2),
                            final_cost=float(c[-1]))
        print(f"{label} {tag}: {it} iters in {wall:.2f}s "
              f"({1000 * wall / it:.1f} ms/iter), final cost {c[-1]:.6g}",
              flush=True)
    s, fl = results["short"], results["full"]
    marg = ((fl["wall_s"] - s["wall_s"]) / (fl["iters"] - s["iters"]))
    entry = {
        "config": f"nmfsc Hoyer(0.6) {m}x{n} r{k} (dispatch=phased)",
        "device": str(jax.devices()[0]),
        "warm_compile_s": round(t_warm, 2),
        **{f"{kk}_{k2}": v2 for kk, vv in results.items()
           for k2, v2 in vv.items()},
        "marginal_ms_per_iter": round(1000 * marg, 2),
        "cost_trace_full": np.asarray(
            nt.nmfsc(V, k, W_init=W0, H_init=H0, maxiter=iters,
                     **kw).cost).tolist() if label == "full" else None,
    }
    data = json.loads(OUT.read_text()) if OUT.exists() else {}
    data[label] = entry
    OUT.write_text(json.dumps(data, indent=1))
    print("wrote", OUT, flush=True)


def cpu_ref(m, n, k, iters):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import nmf_toolbox_tpu as nt
    V, W0, H0 = problem(m, n, k)
    t0 = time.perf_counter()
    r = nt.nmfsc(V, k, W_init=W0, H_init=H0, H_sparsity=0.6,
                 maxiter=iters, tolerance=1e-30)
    wall = time.perf_counter() - t0
    c = np.asarray(r.cost)
    data = json.loads(OUT.read_text()) if OUT.exists() else {}
    data["cpu_ref"] = {
        "config": f"nmfsc Hoyer(0.6) {m}x{n} r{k} fused f32 CPU",
        "iters": iters, "wall_s": round(wall, 3),
        "ms_per_iter": round(1000 * wall / iters, 2),
        "cost_trace": c.tolist(),
    }
    OUT.write_text(json.dumps(data, indent=1))
    print(f"cpu ref: {iters} iters in {wall:.1f}s, final {c[-1]:.6g}",
          flush=True)


STAGES = {
    "small": (500, 200, 10, 6),
    "mid": (2000, 1000, 50, 10),
    "full": (5000, 2000, 50, 30),
}

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", required=True,
                    choices=[*STAGES, "cpu-ref"])
    a = ap.parse_args()
    if a.stage == "cpu-ref":
        cpu_ref(*STAGES["full"])
    else:
        run_stage(*STAGES[a.stage], a.stage)
