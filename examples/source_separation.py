"""End-to-end audio source separation: waveform -> STFT -> multi-source
NMF -> Wiener masks -> iSTFT -> waveform.

Builds a synthetic mixture of a 'tonal' source (steady sines) and a
'percussive' source (decaying noise bursts), learns per-source bases
from solo passages with nmf, separates the mixture with both bases
fixed — the reference toolbox's flagship use case (multi-source
W_fixed workflow, nmf.m:51-60) — and reconstructs time-domain
estimates whose sum equals the mixture exactly.

Run: python examples/source_separation.py  (CPU-friendly, ~seconds)
"""
import numpy as np
# repo root on sys.path so `python examples/x.py` works uninstalled
import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))
import nmf_toolbox_tpu as nt

SR = 8000


def tonal(t, rng, n_tones=3):
    x = np.zeros_like(t)
    for _ in range(n_tones):
        f0 = rng.uniform(200, 900)
        x += rng.uniform(0.3, 0.7) * np.sin(2 * np.pi * f0 * t)
    return x


def percussive(t, rng, n_hits=8):
    x = np.zeros_like(t)
    burst_len = 400
    decay = np.exp(-np.arange(burst_len) / 60.0)
    for onset in rng.uniform(0.05, 0.9, n_hits):
        i = int(onset * len(t))
        hit = rng.normal(size=burst_len) * decay
        x[i: i + burst_len] += 0.8 * hit[: len(x) - i]
    return x


def main():
    rng = np.random.default_rng(0)
    t = np.arange(int(1.5 * SR)) / SR
    a, b = tonal(t, rng), percussive(t, rng)
    mix = a + b

    # 1) spectrograms on device (librosa-convention centered STFT)
    n_fft, hop = 256, 64
    Za = nt.stft(a, n_fft=n_fft, hop_length=hop)
    Zb = nt.stft(b, n_fft=n_fft, hop_length=hop)
    Zm = nt.stft(mix, n_fft=n_fft, hop_length=hop)

    # 2) learn a magnitude basis per source from solo material
    kA, kB = 6, 6
    WA = np.asarray(nt.nmf(np.abs(np.asarray(Za)), kA, maxiter=120, seed=1).W)
    WB = np.asarray(nt.nmf(np.abs(np.asarray(Zb)), kB, maxiter=120, seed=2).W)

    # 3) separate the mixture: both bases fixed, encodings free
    res = nt.nmf(np.abs(np.asarray(Zm)), [kA, kB], W_init=[WA, WB],
                 W_fixed=True, maxiter=150, seed=3)
    HA, HB = res.H

    # 4+5) serving decode in ONE program: Wiener masks on the COMPLEX
    # mixture (masks are real: the estimates reuse the mixture phase and
    # sum to Zm exactly) fused with the batched iSTFT — to keep every
    # boundary buffer real, pass stft(..., planes=True) output instead
    # of Zm (same function)
    ys = np.asarray(nt.separate_waveforms(Zm, [WA, WB], [HA, HB],
                                          hop_length=hop, length=len(mix)))
    ya, yb = ys[0], ys[1]

    def sdr(ref, sig):
        return 10 * np.log10(np.sum(ref**2) / np.sum((ref - sig) ** 2))

    print(f"converged in {res.n_iters} iterations, "
          f"final cost {res.cost[-1]:.3e}")
    print(f"signal SDR tonal:      {sdr(a, ya):6.2f} dB "
          f"(mixture baseline {sdr(a, mix):6.2f} dB)")
    print(f"signal SDR percussive: {sdr(b, yb):6.2f} dB "
          f"(mixture baseline {sdr(b, mix):6.2f} dB)")
    rel = np.linalg.norm(mix - (ya + yb)) / np.linalg.norm(mix)
    print(f"mixture reconstruction rel err: {rel:.2e}  (exact by "
          "construction: masks sum to 1, iSTFT is linear)")
    assert rel < 1e-5
    assert sdr(a, ya) > sdr(a, mix) and sdr(b, yb) > sdr(b, mix)


if __name__ == "__main__":
    main()
