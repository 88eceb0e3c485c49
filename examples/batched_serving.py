"""Serving-style batched factorization: many small spectrograms at once.

One fused vmapped program factorizes a whole request batch (here 256
problems of 257x400 rank-16, 100 MU iterations each; time on the H100
not measured).  Shard the batch axis over a mesh for multi-chip serving.

Run: python examples/batched_serving.py
"""
import time

import numpy as np
# repo root on sys.path so `python examples/x.py` works uninstalled
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import nmf_toolbox_tpu as nt


def main():
    rng = np.random.default_rng(0)
    B, m, n, k = 32, 257, 400, 16
    bases = rng.gamma(2.0, 1.0, (B, m, k)).astype(np.float32)
    codes = rng.gamma(0.5, 1.0, (B, k, n)).astype(np.float32)
    Vs = np.einsum("bmk,bkn->bmn", bases, codes) + 0.01

    t0 = time.time()
    res = nt.nmf_batched(Vs, k, maxiter=100, seed=1)
    dt = time.time() - t0
    rel = np.linalg.norm(
        Vs - np.einsum("bmk,bkn->bmn", res.W, res.H), axis=(1, 2)
    ) / np.linalg.norm(Vs, axis=(1, 2))
    print(f"{B} factorizations x 100 iterations in {dt:.2f}s "
          f"({dt / B * 1e3:.1f} ms/problem incl. compile)")
    print(f"relative errors: median {np.median(rel):.4f}, "
          f"worst {rel.max():.4f}")
    assert np.median(rel) < 0.15

    # Spectrogram serving usually optimizes KL; and at scale the batch
    # dominates HBM — data_dtype="bfloat16" halves the V storage and
    # the dominant read on the euclid path (factors stay f32).
    res_kl = nt.nmf_batched(Vs, k, divergence="kl", maxiter=50, seed=1)
    assert np.all(np.diff(res_kl.cost, axis=1) <= 1e-3)  # KL cost monotone
    res_bf = nt.nmf_batched(Vs, k, maxiter=100, seed=1,
                            data_dtype="bfloat16")
    rel_bf = np.linalg.norm(
        Vs - np.einsum("bmk,bkn->bmn", res_bf.W, res_bf.H), axis=(1, 2)
    ) / np.linalg.norm(Vs, axis=(1, 2))
    print(f"bf16-storage relative errors: median {np.median(rel_bf):.4f}")
    assert np.median(rel_bf) < 0.16

    # Deployment pipeline: train ONE dictionary offline, then each
    # request batch only fits encodings (nmf_encode: H-only MU, euclid
    # iterations V-free after a one-time W'V) and is soft-mask separated
    # — all on device (device_output + the jitted nt.separate).
    kA, kB = 10, 6
    Wdict = np.concatenate([bases[0, :, :kA], bases[1, :, :kB]], axis=1)
    Wdict = (Wdict / np.sqrt((Wdict**2).sum(0))).astype(np.float32)
    t0 = time.time()
    enc = nt.nmf_encode(Vs, Wdict, maxiter=100, seed=2, device_output=True)
    first = nt.separate(Vs[0], [enc.W[:, :kA], enc.W[:, kA:]],
                        [enc.H[0][:kA], enc.H[0][kA:]])
    dt = time.time() - t0
    est = np.asarray(first)
    np.testing.assert_allclose(est.sum(axis=0), Vs[0], rtol=1e-4)
    print(f"encode+separate: {dt:.2f}s for {B} encodes "
          f"({dt / B * 1e3:.1f} ms/problem incl. compile); "
          f"2 sources sum to the mixture exactly")

    # Phase-aware serving: complex request batches (raw STFTs) encode
    # against the SAME magnitude dictionary with per-source phases
    # (cmfwisa_encode).  The boundary is real planes both ways — a
    # device-resident (V_re, V_im) pair in, (P_re, P_im) planes out —
    # so no complex buffer crosses the program boundary.
    import jax.numpy as jnp
    phase = rng.uniform(-np.pi, np.pi, (B, m, n))
    planes = (jnp.asarray(Vs * np.cos(phase), jnp.float32),
              jnp.asarray(Vs * np.sin(phase), jnp.float32))
    t0 = time.time()
    cenc = nt.cmfwisa_encode(planes, Wdict, maxiter=40, seed=3,
                             device_output=True)
    dt = time.time() - t0
    assert np.all(np.diff(cenc.cost, axis=1)
                  <= 1e-4 * np.abs(cenc.cost[:, :-1]))
    print(f"phase-aware encode: {dt:.2f}s for {B} complex encodes "
          f"({dt / B * 1e3:.1f} ms/problem incl. compile); "
          f"costs monotone, phases stay on device as real planes")


if __name__ == "__main__":
    main()
