"""Phase-update microbenchmark: exp(1j*angle(x)) vs unit normalization.

cmfwisa's phase update (cmfwisa.m:183-187) is P = exp(1j*angle(V_bar)).
Mathematically that is V_bar / |V_bar| (with the 0 -> 1+0j convention of
angle(0) = 0), but the two lower very differently on the VPU: the
angle/exp form is an atan2 + sin + cos chain per element, the
normalization form is one rsqrt and two multiplies — and |V_bar| is
ALREADY computed next to it for G = |V_bar| / beta (cmfwisa.m:188).

This measures both forms in context: a scan over the cmfwisa-encode
field shapes (B, S, m, n) doing phase + G, data generated on device
(no host upload).  Decides whether models/cmfwisa.py + batched.py
switch the compute form.

Usage: python benchmarks/phase_update_compare.py [--small]
"""
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

SMALL = "--small" in _sys.argv
if SMALL:
    jax.config.update("jax_platforms", "cpu")
    B, S, M, N, ITERS = 4, 2, 64, 50, 5
else:
    B, S, M, N, ITERS = 256, 2, 257, 400, 100
TRIALS = 4  # first discarded


def make_fields():
    k = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(k, 3)
    re = jax.random.normal(k1, (B, S, M, N), jnp.float32)
    im = jax.random.normal(k2, (B, S, M, N), jnp.float32)
    beta = jax.random.uniform(k3, (B, S, M, N), jnp.float32, 0.1, 1.0)
    return re, im, beta


def run_form(form, tag):
    def phase_angle(vb):
        return jnp.exp(1j * jnp.angle(vb)).astype(vb.dtype), jnp.abs(vb)

    def phase_norm(vb):
        mag = jnp.abs(vb)
        # angle(0) = 0 -> exp(1j*0) = 1: keep the same convention
        p = jnp.where(mag > 0, vb / jnp.where(mag > 0, mag, 1.0),
                      jnp.asarray(1.0, vb.dtype))
        return p.astype(vb.dtype), mag

    phase = {"angle": phase_angle, "norm": phase_norm}[form]

    @jax.jit
    def run(re, im, beta):
        def body(c, _):
            vb = jax.lax.complex(c[0], c[1])
            p, mag = phase(vb)
            g = mag / beta
            # feed the outputs back so the loop cannot be elided
            vb2 = p * g.astype(p.dtype)
            return (jnp.real(vb2), jnp.imag(vb2)), jnp.sum(g)
        (re, im), traces = jax.lax.scan(body, (re, im), None, length=ITERS)
        return re, im, traces

    re, im, beta = make_fields()
    out = run(re, im, beta)
    float(np.ravel(np.asarray(out[2]))[-1])  # completion fence
    dts = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        out = run(out[0], out[1], beta)
        # scalar readback as the completion fence
        float(np.ravel(np.asarray(out[2]))[-1])
        dts.append(time.perf_counter() - t0)
    dts = dts[1:]
    med = sorted(dts)[len(dts) // 2]
    ms = med * 1e3 / ITERS
    print(f"{tag}: {ms:.3f} ms/iter over (B,S,m,n)=({B},{S},{M},{N}) "
          f"trials={['%.3f' % (d * 1e3 / ITERS) for d in dts]}", flush=True)
    return ms


def main():
    print(f"device: {jax.devices()[0]}", flush=True)
    r = {"angle_ms_per_iter": run_form("angle", "exp(1j*angle)"),
         "norm_ms_per_iter": run_form("norm", "unit-normalize")}
    r["speedup"] = r["angle_ms_per_iter"] / r["norm_ms_per_iter"]
    # max elementwise deviation of the two forms on one pass (one jitted
    # program returning a REAL scalar — no complex buffer crosses the
    # program boundary)
    @jax.jit
    def dev(re, im):
        vb = jax.lax.complex(re, im)
        a = jnp.exp(1j * jnp.angle(vb))
        mag = jnp.abs(vb)
        nrm = jnp.where(mag > 0, vb / jnp.where(mag > 0, mag, 1.0), 1.0 + 0j)
        return jnp.max(jnp.abs(a - nrm))

    re, im, _ = make_fields()
    r["max_abs_dev_f32"] = float(dev(re, im))
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
