"""Batched serving throughput: euclid f32, euclid bf16-storage, KL.

Quantifies the `nmf_batched` serving path (RESULTS row "serving extra")
across its round-3 options: KL (the spectrogram serving objective) and
data_dtype="bfloat16" (halves the dominant HBM read).  Methodology per
benchmarks rules: inputs uploaded once, first call per compiled shape
discarded, scalar-readback fence, median over repeats.

Usage: python benchmarks/batched_serving.py [--quick] [--cpu]
Writes benchmarks/BATCHED_SERVING.json (full accelerator runs only).
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "BATCHED_SERVING.json"


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
        B, m, n, k, iters, repeats = 16, 65, 100, 8, 50, 2
    else:
        B, m, n, k, iters, repeats = 256, 257, 400, 16, 100, 3

    rng = np.random.default_rng(0)
    bases = rng.gamma(2.0, 1.0, (B, m, k)).astype(np.float32)
    codes = rng.gamma(0.5, 1.0, (B, k, n)).astype(np.float32)
    Vs = jnp.asarray(np.einsum("bmk,bkn->bmn", bases, codes) + 0.01)
    Vs.block_until_ready()

    def timed(label, **cfg):
        def call(fetch):
            # device_output=True: the solve + the (B,) cost fence only.
            # fetch=True additionally pulls the factors to the host.
            r = nt.nmf_batched(Vs, k, maxiter=iters, seed=1,
                               device_output=not fetch, **cfg)
            if fetch:
                np.asarray(r.W), np.asarray(r.H)
            return float(np.asarray(r.cost)[:, -1].sum())  # fence
        t = time.perf_counter(); call(False); compile_s = time.perf_counter() - t
        def med(fetch):
            ts = []
            for _ in range(repeats):
                t = time.perf_counter(); call(fetch)
                ts.append(time.perf_counter() - t)
            return statistics.median(ts)
        dev, e2e = med(False), med(True)
        row = {"device_s": round(dev, 4),
               "ms_per_problem_device": round(1e3 * dev / B, 3),
               "with_host_fetch_s": round(e2e, 4),
               "compile_s": round(compile_s, 1)}
        print(f"{label}: {row}", flush=True)
        return row

    rows = {
        "euclid_f32": timed("euclid_f32"),
        "euclid_bf16_storage": timed("euclid_bf16_storage",
                                     data_dtype="bfloat16"),
        "kl_f32": timed("kl_f32", divergence="kl"),
    }

    # Fixed-dictionary encoding (nmf_encode / cnmf_encode): ONE shared
    # trained W, H-only MU for the whole stack.  Euclid iterations are
    # V-free after the one-time W'V, so this is the serving fast path.
    Wd = jnp.asarray(bases[0] / np.sqrt((bases[0] ** 2).sum(0)))
    T = 4
    Wc = jnp.asarray(rng.gamma(2.0, 1.0, (m, k, T)).astype(np.float32))
    Wd.block_until_ready(); Wc.block_until_ready()

    def timed_encode(label, engine, Wdict, extra_row=None, data=None,
                     **cfg):
        Vin = Vs if data is None else data

        def call():
            r = engine(Vin, Wdict, maxiter=iters, seed=1,
                       device_output=True, **cfg)
            return float(np.asarray(r.cost)[:, -1].sum())  # fence
        t = time.perf_counter(); call(); compile_s = time.perf_counter() - t
        ts = []
        for _ in range(repeats):
            t = time.perf_counter(); call()
            ts.append(time.perf_counter() - t)
        dev = statistics.median(ts)
        row = {"device_s": round(dev, 4),
               "ms_per_problem_device": round(1e3 * dev / B, 3),
               "compile_s": round(compile_s, 1), **(extra_row or {})}
        print(f"{label}: {row}", flush=True)
        return row

    rows["encode_euclid_f32"] = timed_encode(
        "encode_euclid_f32", nt.nmf_encode, Wd)
    rows["encode_kl_f32"] = timed_encode(
        "encode_kl_f32", nt.nmf_encode, Wd, divergence="kl")
    rows["conv_encode_euclid_f32"] = timed_encode(
        "conv_encode_euclid_f32", nt.cnmf_encode, Wc, {"T": T})
    rows["conv_encode_kl_f32"] = timed_encode(
        "conv_encode_kl_f32", nt.cnmf_encode, Wc, {"T": T}, divergence="kl")
    # Phase-aware complex encode (cmfwisa_encode): H + per-source phases
    # against the frozen magnitude dictionary.  device_output keeps the
    # (B, S, m, n) phase planes on device (no ~2 B*m*n*4-byte host fetch).
    # 2-D deconvolutional encode (pitch-invariant transcription serving).
    Wd2 = jnp.asarray(rng.gamma(2.0, 1.0, (m, k, 3)).astype(np.float32))
    Wd2.block_until_ready()
    rows["nmf2d_encode_f32"] = timed_encode(
        "nmf2d_encode_f32",
        lambda Vx, Wx, **kw: nt.nmf2d_encode(Vx, Wx, 4, **kw),
        Wd2, {"T": 3, "P": 4})

    phase = rng.uniform(-np.pi, np.pi, Vs.shape)
    Vc_re = jnp.asarray((np.asarray(Vs) * np.cos(phase)).astype(np.float32))
    Vc_im = jnp.asarray((np.asarray(Vs) * np.sin(phase)).astype(np.float32))
    Vc_re.block_until_ready(); Vc_im.block_until_ready()
    rows["cmf_encode_c64"] = timed_encode(
        "cmf_encode_c64", nt.cmfwisa_encode, Wd, data=(Vc_re, Vc_im))
    out = {"config": {"B": B, "m": m, "n": n, "k": k, "maxiter": iters,
                      "repeats": repeats, "quick": quick},
           "rows": rows, "device": str(jax.devices()[0])}
    print(json.dumps({k: v["device_s"] for k, v in rows.items()}))
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
