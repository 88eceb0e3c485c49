"""KL W-phase on the GPU: the Pallas/Triton kernel against XLA's naive form.

Times ``(V / (W @ H)) @ H'`` at 40k x 10k rank 100 two ways (the kernel
over six tilings), then ``nt.nmf(divergence="kl")`` end to end with
``method="naive"`` against ``method="fused"``, in turns.  Prints one JSON
line per measurement and the card's name and power limit.  Needs a GPU:

    python benchmarks/kl_wphase_compare.py [--m 40000 --n 10000 --k 100]
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
from nmf_toolbox_tpu.ops.fused_kl import kl_ratio_dot_ht
from nmf_toolbox_tpu.ops.normalize import unit_l2_columns

METHODS = ("naive", "fused", "fused", "naive")


def _time(fn, args, reps=20, rounds=5):
    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps)
    return float(np.median(per)), [float(x) for x in per]


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=40_000)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(kv, (a.m, a.n), jnp.float32, 0.05, 1.0)
    W = unit_l2_columns(jax.random.uniform(kw, (a.m, a.k), jnp.float32))
    H = jax.random.uniform(kh, (a.k, a.n), jnp.float32)

    xla = jax.jit(lambda V, W, H: (V / (W @ H)) @ H.T)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda V, W, H: (V / (W @ H)) @ H.T)(V, W, H)
    scale = float(jnp.max(jnp.abs(ref)))
    t_xla, runs = _time(xla, (V, W, H))
    dev_xla = float(jnp.max(jnp.abs(xla(V, W, H) - ref))) / scale
    print(json.dumps({"phase": "xla_naive", "ms": t_xla * 1e3,
                      "runs_ms": [r * 1e3 for r in runs],
                      "max_rel_dev_vs_highest": dev_xla}))
    best = None
    for bm, bn, nw, ns in [(64, 64, 4, 2), (64, 128, 4, 2), (128, 64, 8, 2),
                           (64, 64, 4, 3), (32, 128, 4, 3), (128, 128, 8, 2)]:
        fn = jax.jit(lambda V, W, H, bm=bm, bn=bn, nw=nw, ns=ns:
                     kl_ratio_dot_ht(V, W, H, block_m=bm, block_n=bn,
                                     num_warps=nw, num_stages=ns))
        cfg = {"block_m": bm, "block_n": bn, "num_warps": nw,
               "num_stages": ns}
        try:
            t, runs = _time(fn, (V, W, H))
        except Exception as e:  # a config the compiler refuses
            print(json.dumps({"phase": "triton", **cfg,
                              "error": f"{type(e).__name__}: {e}"[:300]}))
            continue
        d = float(jnp.max(jnp.abs(fn(V, W, H) - ref))) / scale
        print(json.dumps({"phase": "triton", **cfg, "ms": t * 1e3,
                          "runs_ms": [r * 1e3 for r in runs],
                          "max_rel_dev_vs_highest": d}))
        if best is None or t < best[0]:
            best = (t, cfg)
    if best is None:
        return 1
    print(json.dumps({"best_tiles": best[1]}))
    # End to end: nt.nmf KL through the naive path and through
    # method='fused' (the kernel at its default tiles), same init.
    def solve(method):
        t0 = time.perf_counter()
        r = nt.nmf(V, a.k, W_init=W, H_init=H, divergence="kl",
                   method=method, maxiter=a.iters, tolerance=1e-30)
        return time.perf_counter() - t0, float(r.cost[-1])

    for name in METHODS:
        solve(name)  # compile
    for name in METHODS * 3:
        runs = [solve(name) for _ in range(5)]
        t = float(np.median([r[0] for r in runs]))
        print(json.dumps({"nmf_method": name,
                          "ms_per_iter": t * 1e3 / a.iters,
                          "runs_ms_per_iter": [r[0] * 1e3 / a.iters
                                               for r in runs],
                          "final_cost": runs[-1][1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
