"""Decompose the flagship gram iteration: where do 8.8 ms/iter go?

Each component runs as a 20-iteration lax.scan whose carry depends on the
previous output (no per-dispatch overhead in the margin),
timed with the chained-dispatch methodology of profile_flagship.py.

IMPORTANT: the large operands must be ARGUMENTS of the jitted function,
never closed-over jnp arrays — a closed-over device array becomes a jit
CONSTANT embedded in the compiled program (4 GB for V).

Components at (m, n, k) = (100k, 10k, 200), V f32 (and bf16 variants):
  dot1      y = V @ H.T                 (the W-update numerator, nmf.m:149)
  dot2      y = V.T @ W   (as dot_general, no transpose node; nmf.m:180)
  dot2t     y = V.T @ W   (with an explicit transpose node)
  gramrest  everything in the gram step EXCEPT the two V dots

Usage: python benchmarks/microbench_gram.py [job]   (default "all")
"""
# repo root on sys.path: these scripts run as 'python benchmarks/x.py'
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

M = int(os.environ.get("MB_M", 100_000))
N = int(os.environ.get("MB_N", 10_000))
K = int(os.environ.get("MB_K", 200))
ITERS = 20
TRIALS = 4


def chained(step, data, carry, tag):
    """step(data, carry) -> carry; data are loop-invariant device args."""
    def body(data, c):
        return jax.lax.scan(lambda c, _: (step(data, c), None),
                            c, None, length=ITERS)[0]
    run = jax.jit(body)
    out = run(data, carry)
    jax.block_until_ready(out)
    float(np.ravel(np.asarray(jax.tree_util.tree_leaves(out)[0]))[0])  # fence
    dts = []
    c = out
    for _ in range(TRIALS):
        jax.block_until_ready(c)
        t0 = time.perf_counter()
        c = run(data, c)
        jax.block_until_ready(c)
        float(np.ravel(np.asarray(jax.tree_util.tree_leaves(c)[0]))[0])
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    ms = sorted(dts)[len(dts) // 2] * 1e3 / ITERS
    print(f"{tag}: {ms:.3f} ms/iter "
          f"trials={['%.2f' % (d*1e3/ITERS) for d in dts]}", flush=True)
    return ms


def dot1(V, H):
    y = jax.lax.dot(V, H.T.astype(V.dtype), preferred_element_type=jnp.float32)
    return H * (1.0 + 1e-12 * jnp.mean(y))


def dot2(V, W):
    # V.T @ W without a transpose node: contract dim 0 with dim 0
    y = jax.lax.dot_general(V, W.astype(V.dtype), (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return W * (1.0 + 1e-12 * jnp.mean(y))


def dot2_tnode(V, W):
    y = jax.lax.dot(V.T, W.astype(V.dtype), preferred_element_type=jnp.float32)
    return W * (1.0 + 1e-12 * jnp.mean(y))


def gramrest(data, carry):
    VHt0, WtV0 = data
    W, H = carry
    eps = jnp.float32(2.220446049250313e-16)
    HHt = H @ H.T
    WG = W @ HHt
    dneg = jnp.sum(W * WG, axis=0)
    dpos = jnp.sum(W * VHt0, axis=0)
    neg = VHt0 + W * dneg[None, :]
    pos = WG + W * dpos[None, :]
    Wn = W * (neg / jnp.maximum(pos, eps))
    Wn = Wn / jnp.sqrt(jnp.maximum(jnp.sum(Wn * Wn, axis=0), eps))[None, :]
    WtW = Wn.T @ Wn
    Hn = H * (WtV0 / jnp.maximum(WtW @ H, eps))
    c = jnp.sum(WtV0 * Hn) * 1e-12
    return Wn * (1.0 + c), Hn


def main():
    print(f"device: {jax.devices()[0]}", flush=True)
    key = jax.random.PRNGKey(0)
    kv, kw, kh = jax.random.split(key, 3)
    V = jax.random.uniform(kv, (M, N), jnp.float32, 0.05, 1.0)
    W = jax.random.uniform(kw, (M, K), jnp.float32)
    H = jax.random.uniform(kh, (K, N), jnp.float32)
    jax.block_until_ready((V, W, H))
    r = {}

    which = sys.argv[1] if len(sys.argv) > 1 else "all"

    def want(name):
        return which in ("all", name)

    if want("dot1_f32"):
        r["dot1_f32"] = chained(dot1, V, H, "dot1 V@H' (f32 V)")
    if want("dot2_f32"):
        r["dot2_f32"] = chained(dot2, V, W, "dot2 V'W dot_general (f32 V)")
    if want("dot2t_f32"):
        r["dot2t_f32"] = chained(dot2_tnode, V, W,
                                 "dot2 V.T@W transpose-node (f32 V)")
    if want("dot1_bf16") or want("dot2_bf16"):
        Vb = jax.jit(lambda x: x.astype(jnp.bfloat16))(V)
        jax.block_until_ready(Vb)
        if want("dot1_bf16"):
            r["dot1_bf16"] = chained(dot1, Vb, H, "dot1 V@H' (bf16 V)")
        if want("dot2_bf16"):
            r["dot2_bf16"] = chained(dot2, Vb, W,
                                     "dot2 V'W dot_general (bf16 V)")
    if want("gramrest"):
        VHt0 = jax.random.normal(jax.random.PRNGKey(1), (M, K), jnp.float32)
        WtV0 = jax.random.normal(jax.random.PRNGKey(2), (K, N), jnp.float32)
        jax.block_until_ready((VHt0, WtV0))
        r["gramrest"] = chained(gramrest, (VHt0, WtV0), (W, H),
                                "gram remainder (no V dots)")
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
