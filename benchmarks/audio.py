"""On-chip timings for the audio front-end (stft / istft / griffinlim).

Methodology: inputs uploaded once, compile warmed, perturbed trials with a
scalar-readback fence, median over repeats.  Shapes: a one-minute 16 kHz
mono clip (960k samples) and a 64-clip serving batch of 1-second utterances.

Usage: python benchmarks/audio.py [--quick] [--cpu]
Writes benchmarks/AUDIO.json (full accelerator runs only).
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "AUDIO.json"


def main(quick: bool, write: bool):
    import numpy as np
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    assert float(jax.jit(lambda x: (x * x).sum())(jnp.ones((4, 4)))) == 16.0

    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.utils.audio import griffinlim

    if quick:
        L, B, Lb, n_fft, hop, gl_iters, repeats = 80_000, 8, 8_000, 512, 128, 8, 2
    else:
        L, B, Lb, n_fft, hop, gl_iters, repeats = 960_000, 64, 16_000, 1024, 256, 32, 3

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=L).astype(np.float32))
    xb = jnp.asarray(rng.normal(size=(B, Lb)).astype(np.float32))
    x.block_until_ready(); xb.block_until_ready()
    ent = np.random.default_rng()  # perturbs each trial's input

    def timed(label, fn, fence, perturb):
        float(fence(fn(jnp.float32(1.0))))  # warm compile, FENCED
        ts = []
        for _ in range(repeats):
            f = jnp.float32(1.0 + 1e-6 * ent.uniform(0.1, 1.0))
            if perturb:
                jax.block_until_ready(f)
            t0 = time.perf_counter()
            out = fn(f)
            float(fence(out))  # scalar readback = completion fence
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        print(f"{label}: {med * 1e3:.2f} ms", flush=True)
        return round(med * 1e3, 3)

    # All boundaries use the PLANES form (real (2, ...) stacks), the
    # production serving boundary (utils/audio.py stft planes=True).
    rows = {}
    rows["stft_1min_ms"] = timed(
        "stft 1-min clip",
        lambda f: nt.stft(x * f, n_fft=n_fft, hop_length=hop, planes=True),
        lambda P: jnp.sum(jnp.abs(P[:, :, -1])), perturb=True)
    Zp = nt.stft(x, n_fft=n_fft, hop_length=hop, planes=True)
    jax.block_until_ready(Zp)
    rows["istft_1min_ms"] = timed(
        "istft 1-min clip",
        lambda f: nt.istft(Zp * f, hop_length=hop, length=L, planes=True),
        lambda y: jnp.sum(y[-100:]), perturb=True)
    rows["stft_batch64_ms"] = timed(
        f"stft {B}-clip batch",
        lambda f: nt.stft(xb * f, n_fft=n_fft, hop_length=hop, planes=True),
        lambda Pb: jnp.sum(jnp.abs(Pb[:, :, :, -1])), perturb=True)
    P1 = nt.stft(xb[0], n_fft=n_fft, hop_length=hop, planes=True)
    mag = nt.magnitude(P1, planes=True)  # |Z| without a complex boundary
    jax.block_until_ready(mag)
    rows["griffinlim_1s_ms"] = timed(
        f"griffinlim {gl_iters} iters, 1-s clip",
        lambda f: griffinlim(mag * f, n_iter=gl_iters, hop_length=hop,
                             length=Lb),
        lambda y: jnp.sum(y[-100:]), perturb=True)
    out = {"config": {"L": L, "B": B, "Lb": Lb, "n_fft": n_fft, "hop": hop,
                      "gl_iters": gl_iters, "repeats": repeats,
                      "quick": quick},
           "rows_ms": rows, "device": str(jax.devices()[0])}
    print(json.dumps(rows))
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
