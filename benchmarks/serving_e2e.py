"""End-to-end serving pipeline on chip: waveform -> STFT -> fixed-basis
encode -> Wiener masks + phase reuse -> iSTFT -> waveforms, with SDR.

This is the separation application the reference cites but never ships
(cmfwisa.m:88-91 and the application papers around cnmf.m:107-113): the
whole loop runs on device, every boundary buffer REAL (the planar STFT
forms from utils/audio.py), the decode fused into one dispatch
(utils/separation.separate_waveforms).

Offline (untimed): learn per-source bases from solo passages.
Timed, per trial:  stft(planes) -> magnitude -> nmf KL encode with both
bases fixed -> separate_waveforms (masks + phase + iSTFT in ONE
program) -> scalar fence.  Reports wall-clock, x-realtime, and the SDR
improvement over the mixture for both sources (untimed, host-side).

Usage: python benchmarks/serving_e2e.py [--quick] [--cpu]
Writes benchmarks/SERVING_E2E.json (full runs only).
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "SERVING_E2E.json"

SR = 16_000


def tonal(t, rng, n_tones=4):
    import numpy as np
    x = np.zeros_like(t)
    for _ in range(n_tones):
        f0 = rng.uniform(150, 1200)
        x += rng.uniform(0.3, 0.7) * np.sin(2 * np.pi * f0 * t)
    return x


def percussive(t, rng, hits_per_sec=4.0):
    import numpy as np
    x = np.zeros_like(t)
    burst = 600
    decay = np.exp(-np.arange(burst) / 90.0)
    n_hits = int(hits_per_sec * t[-1])
    for onset in rng.uniform(0.01, 0.98, n_hits):
        i = int(onset * len(t))
        hit = rng.normal(size=burst) * decay
        x[i: i + burst] += 0.8 * hit[: len(x) - i]
    return x


def main(quick: bool, write: bool):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.utils import separate_waveforms

    print("devices:", jax.devices(), flush=True)
    assert float(jax.jit(lambda v: (v * v).sum())(jnp.ones((4, 4)))) == 16.0

    secs = 4.0 if quick else 60.0
    n_fft, hop = (512, 128) if quick else (1024, 256)
    enc_iters = 20 if quick else 50
    kA, kB = 8, 8
    repeats = 2 if quick else 3

    rng = np.random.default_rng(0)
    t = np.arange(int(secs * SR)) / SR
    a, b = tonal(t, rng), percussive(t, rng)
    a /= np.sqrt(np.mean(a ** 2))  # equal-power sources: the SDR
    b /= np.sqrt(np.mean(b ** 2))  # baseline is then ~0 dB for both
    mix = (a + b).astype(np.float32)
    L = len(mix)

    # ---- offline: learn per-source bases from solo passages ----------
    def mag_of(sig):
        P = nt.stft(jnp.asarray(sig.astype(np.float32)), n_fft=n_fft,
                    hop_length=hop, planes=True)
        return nt.magnitude(P, planes=True)

    WA = nt.nmf(mag_of(a), kA, divergence="kl", maxiter=100, seed=1).W
    WB = nt.nmf(mag_of(b), kB, divergence="kl", maxiter=100, seed=2).W
    jax.block_until_ready((WA, WB))

    # ---- the timed pipeline -------------------------------------------
    x_dev = jnp.asarray(mix)
    jax.block_until_ready(x_dev)

    def pipeline(f):
        P = nt.stft(x_dev * f, n_fft=n_fft, hop_length=hop, planes=True)
        mag = nt.magnitude(P, planes=True)
        res = nt.nmf(mag, [kA, kB], W_init=[WA, WB], W_fixed=True,
                     divergence="kl", maxiter=enc_iters, tolerance=0.0,
                     seed=3)
        y = separate_waveforms(P, [WA, WB], list(res.H),
                               hop_length=hop, length=L)
        return y

    ent = np.random.default_rng()
    y = pipeline(jnp.float32(1.0))                     # warm every compile
    float(jnp.sum(y[:, -100:]))
    ts = []
    for _ in range(repeats):
        f = jnp.float32(1.0 + 1e-6 * ent.uniform(0.1, 1.0))
        jax.block_until_ready(f)
        t0 = time.perf_counter()
        y = pipeline(f)
        float(jnp.sum(y[:, -100:]))                    # scalar fence
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    xrt = secs / med

    # ---- quality (untimed, host) --------------------------------------
    ya, yb = np.asarray(y[0]), np.asarray(y[1])

    def sdr(ref, sig):
        return float(10 * np.log10(np.sum(ref ** 2)
                                   / np.sum((ref - sig) ** 2)))

    rel = float(np.linalg.norm(mix - (ya + yb)) / np.linalg.norm(mix))
    rows = {
        "pipeline_wall_ms": round(med * 1e3, 2),
        "x_realtime": round(xrt, 1),
        "clip_seconds": secs,
        "encode_iters": enc_iters,
        "sdr_tonal_db": round(sdr(a, ya), 2),
        "sdr_tonal_mix_baseline_db": round(sdr(a, mix), 2),
        "sdr_percussive_db": round(sdr(b, yb), 2),
        "sdr_percussive_mix_baseline_db": round(sdr(b, mix), 2),
        "mixture_recon_rel_err": rel,
    }
    ok = (rows["sdr_tonal_db"] > rows["sdr_tonal_mix_baseline_db"]
          and rows["sdr_percussive_db"] > rows["sdr_percussive_mix_baseline_db"]
          and rel < 1e-4)
    out = {"config": {"sr": SR, "n_fft": n_fft, "hop": hop, "kA": kA,
                      "kB": kB, "repeats": repeats, "quick": quick},
           "rows": rows, "ok": bool(ok), "device": str(jax.devices()[0])}
    print(json.dumps(rows), flush=True)
    print(f"separation quality ok: {ok}", flush=True)
    if write:
        OUT.write_text(json.dumps(out, indent=1) + "\n")
        print(f"wrote {OUT}")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    sys.exit(main(args.quick, write=not (args.quick or args.cpu)))
