"""nmfsc line search on the GPU: sequential halving against batched trials.

Times ``nt.nmfsc`` at 5000 x 2000 rank 50 with Hoyer sparsity 0.6 on H
(BASELINE #2) for ``linesearch_width`` 0 (sequential halving) and 8
(eight halvings per batched trial round), in turns 0, 8, 8, 0 twice,
after a warm-up run of each at the same iteration count.  Prints the
card's name and power limit and one JSON line per timed run.  Needs a
GPU:

    python benchmarks/linesearch_width.py [--maxiter 30]
"""
# repo root on sys.path: these scripts run as 'python benchmarks/x.py'
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import nmf_toolbox_tpu as nt


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=30)
    a = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    rng = np.random.default_rng(3)
    m, n, k = 5000, 2000, 50
    V = jnp.asarray(rng.uniform(0.1, 1.0, (m, n)).astype(np.float32))
    W0 = jnp.asarray(rng.uniform(size=(m, k)).astype(np.float32))
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    H0 = jnp.asarray(H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True)))
    kw = dict(W_init=W0, H_init=H0, H_sparsity=0.6, tolerance=1e-30)
    costs = {}
    for w in (0, 8):
        np.asarray(nt.nmfsc(V, k, maxiter=a.maxiter, linesearch_width=w,
                            **kw).cost)
    for w in (0, 8, 8, 0, 0, 8, 8, 0):
        t0 = time.perf_counter()
        r = nt.nmfsc(V, k, maxiter=a.maxiter, linesearch_width=w, **kw)
        c = np.asarray(r.cost)
        dt = time.perf_counter() - t0
        costs[w] = c
        print(json.dumps({"linesearch_width": w, "wall_s": dt,
                          "ms_per_iter": 1e3 * dt / a.maxiter,
                          "n_iters": int(r.n_iters),
                          "final_cost": float(c[-1])}))
    rel = float(np.max(np.abs(costs[0] - costs[8])
                       / np.maximum(np.abs(costs[0]), 1e-30)))
    print(json.dumps({"cost_trace_max_rel_diff_0_vs_8": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
