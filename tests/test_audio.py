"""STFT / iSTFT front-end (utils/audio.py).

Pins: framing+window+rfft against a literal NumPy reference, scipy
cross-check of the window convention, NOLA round-trip exactness across
hop/n_fft/length combinations, batching, dtype behavior, and the
end-to-end audio loop (signal -> stft -> wiener separate -> istft).
"""
import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

import nmf_toolbox_tpu as nt
from nmf_toolbox_tpu.utils.audio import hann_window, magnitude


def np_stft_ref(x, n_fft, hop, center):
    """Literal framing reference: reflect pad, periodic hann, rfft."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    if center:
        x = np.pad(x, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    F = np.stack([np.fft.rfft(x[t * hop: t * hop + n_fft] * w)
                  for t in range(n_frames)], axis=1)
    return F


def test_window_matches_scipy():
    w = np.asarray(hann_window(64, jnp.float64))
    ref = scipy.signal.get_window("hann", 64, fftbins=True)
    np.testing.assert_allclose(w, ref, atol=1e-12)


@pytest.mark.parametrize("center", [True, False])
def test_stft_matches_numpy_reference(center):
    rng = np.random.default_rng(0)
    x = rng.normal(size=1000)
    Z = np.asarray(nt.stft(x, n_fft=128, hop_length=32, center=center))
    ref = np_stft_ref(x, 128, 32, center)
    assert Z.shape == ref.shape == (65, ref.shape[1])
    np.testing.assert_allclose(Z, ref, atol=1e-10)


@pytest.mark.parametrize("n_fft,hop,length", [
    (128, 32, 1000),   # default-style 4x overlap
    (128, 64, 1000),   # 2x overlap (NOLA boundary for hann)
    (256, 64, 777),    # length not a multiple of hop
    (64, 16, 64),      # minimal length == n_fft
    (128, 48, 500),    # hop not dividing n_fft
])
def test_roundtrip_center(n_fft, hop, length):
    rng = np.random.default_rng(1)
    x = rng.normal(size=length)
    Z = nt.stft(x, n_fft=n_fft, hop_length=hop)
    y = np.asarray(nt.istft(Z, hop_length=hop, length=length))
    np.testing.assert_allclose(y, x, atol=1e-8)


def test_roundtrip_uncentered_interior():
    # center=False: only the NOLA-covered interior reconstructs; the
    # first/last (n_fft - hop) samples lack full window overlap.
    rng = np.random.default_rng(2)
    n_fft, hop = 128, 32
    x = rng.normal(size=1024)
    Z = nt.stft(x, n_fft=n_fft, hop_length=hop, center=False)
    y = np.asarray(nt.istft(Z, hop_length=hop, center=False))
    n_frames = 1 + (1024 - n_fft) // hop
    assert y.shape[-1] == n_fft + hop * (n_frames - 1)
    lo, hi = n_fft - hop, y.shape[-1] - (n_fft - hop)
    np.testing.assert_allclose(y[lo:hi], x[lo:hi], atol=1e-8)


def test_batched_leading_dims():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 600))
    Z = nt.stft(x, n_fft=128, hop_length=32)
    assert Z.shape[:2] == (2, 3) and Z.shape[2] == 65
    # batched == per-signal
    Z00 = nt.stft(x[0, 0], n_fft=128, hop_length=32)
    np.testing.assert_allclose(np.asarray(Z[0, 0]), np.asarray(Z00),
                               atol=1e-12)
    y = np.asarray(nt.istft(Z, hop_length=32, length=600))
    np.testing.assert_allclose(y, x, atol=1e-8)


def test_rect_window_and_custom_array():
    rng = np.random.default_rng(4)
    x = rng.normal(size=512)
    Zr = nt.stft(x, n_fft=64, hop_length=64, window="rect", center=False)
    # rect @ hop == n_fft is a plain blocked rfft
    blocks = x.reshape(8, 64)
    np.testing.assert_allclose(np.asarray(Zr), np.fft.rfft(blocks, axis=1).T,
                               atol=1e-10)
    # custom window as a RAW ARRAY (canonicalized to a hashable tuple
    # before the jit-static boundary) and as a tuple: identical
    w = np.hamming(64)
    Zc = nt.stft(x, n_fft=64, hop_length=16, window=w)
    Zt = nt.stft(x, n_fft=64, hop_length=16, window=tuple(w))
    np.testing.assert_allclose(np.asarray(Zc), np.asarray(Zt), atol=0)
    y = nt.istft(Zc, hop_length=16, window=w, length=512)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-8)


def test_dtype_and_errors():
    x32 = np.random.default_rng(5).normal(size=300).astype(np.float32)
    Z = nt.stft(x32, n_fft=64)
    assert np.asarray(Z).dtype == np.complex64
    y = nt.istft(Z, length=300)
    assert np.asarray(y).dtype == np.float32
    with pytest.raises(TypeError):
        nt.stft(np.asarray(Z))          # complex input rejected
    with pytest.raises(ValueError):
        nt.stft(x32, n_fft=64, hop_length=0)
    with pytest.raises(ValueError):
        nt.stft(np.zeros(10), n_fft=64, center=False)  # too short
    with pytest.raises(ValueError):
        nt.stft(x32, n_fft=64, window="blackman")
    with pytest.raises(ValueError, match="even"):
        nt.stft(x32, n_fft=65)  # odd n_fft would break istft's inference
    with pytest.raises(ValueError):
        nt.istft(jnp.zeros((1,), jnp.complex64))


def test_istft_length_pads_and_trims():
    x = np.random.default_rng(6).normal(size=500)
    Z = nt.stft(x, n_fft=128, hop_length=32)
    long = np.asarray(nt.istft(Z, hop_length=32, length=600))
    assert long.shape == (600,)
    np.testing.assert_allclose(long[:500], x, atol=1e-8)
    # beyond the frame-covered span (608 padded - 64 left trim = 544) the
    # output is zero-padded; 500..543 reconstruct the analysis padding
    np.testing.assert_allclose(long[544:], 0.0)
    assert np.all(np.isfinite(long))
    short = np.asarray(nt.istft(Z, hop_length=32, length=200))
    np.testing.assert_allclose(short, x[:200], atol=1e-8)


def test_magnitude_helper():
    Z = np.array([[3 + 4j, 0.0]])
    np.testing.assert_allclose(np.asarray(magnitude(Z)), [[5.0, 0.0]])
    np.testing.assert_allclose(np.asarray(magnitude(Z, power=2.0)),
                               [[25.0, 0.0]])


def test_end_to_end_signal_separation():
    """The full audio loop: two signals -> mixture STFT -> magnitude NMF
    with per-source fixed bases -> wiener masks -> iSTFT.  The separated
    waveforms must (a) sum to the mixture exactly and (b) correlate with
    the true sources far better than the mixture does."""
    sr, dur = 8000, 1.0
    t = np.arange(int(sr * dur)) / sr
    rng = np.random.default_rng(7)
    # tonal source: two steady sines; percussive source: decaying bursts
    a = 0.6 * np.sin(2 * np.pi * 440 * t) + 0.4 * np.sin(2 * np.pi * 660 * t)
    b = np.zeros_like(t)
    for onset in np.linspace(0.05, 0.85, 7):
        i = int(onset * sr)
        burst = rng.normal(size=400) * np.exp(-np.arange(400) / 60.0)
        b[i: i + 400] += 0.8 * burst
    mix = a + b

    n_fft, hop = 256, 64
    Za, Zb, Zm = (nt.stft(s, n_fft=n_fft, hop_length=hop)
                  for s in (a, b, mix))
    WA = np.asarray(nt.nmf(np.abs(np.asarray(Za)), 4, maxiter=80, seed=1).W)
    WB = np.asarray(nt.nmf(np.abs(np.asarray(Zb)), 4, maxiter=80, seed=2).W)
    res = nt.nmf(np.abs(np.asarray(Zm)), [4, 4], W_init=[WA, WB],
                 W_fixed=True, maxiter=120, seed=3)
    est = nt.separate(Zm, [WA, WB], list(res.H))  # complex: mixture phase
    np.testing.assert_allclose(np.asarray(est.sum(0)), np.asarray(Zm),
                               atol=1e-6)
    ya = np.asarray(nt.istft(est[0], hop_length=hop, length=len(mix)))
    yb = np.asarray(nt.istft(est[1], hop_length=hop, length=len(mix)))
    np.testing.assert_allclose(ya + yb, mix, atol=1e-5)

    def sdr(ref, sig):
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - sig) ** 2))

    # separation must beat the trivial "mixture as estimate" baseline by
    # a wide margin on both sources
    assert sdr(a, ya) > sdr(a, mix) + 6.0
    assert sdr(b, yb) > sdr(b, mix) + 6.0


def test_cmfwisa_signal_level():
    """Phase-aware path: complex STFT -> cmfwisa (per-source phases) ->
    iSTFT.  The per-source complex estimates (W_i H_i) * P_i sum to the
    model's V_hat, and the reconstructed waveforms separate better than
    the mixture baseline."""
    sr = 8000
    t = np.arange(int(0.8 * sr)) / sr
    rng = np.random.default_rng(11)
    a = 0.6 * np.sin(2 * np.pi * 523 * t)
    b = np.zeros_like(t)
    for i in range(300, len(t) - 300, 1100):
        b[i: i + 250] += 0.7 * rng.normal(size=250) * np.exp(
            -np.arange(250) / 50.0)
    mix = a + b

    n_fft, hop = 256, 64
    Zm = np.asarray(nt.stft(mix, n_fft=n_fft, hop_length=hop))
    WA = np.asarray(nt.nmf(np.abs(np.asarray(
        nt.stft(a, n_fft=n_fft, hop_length=hop))), 3, maxiter=60, seed=1).W)
    WB = np.asarray(nt.nmf(np.abs(np.asarray(
        nt.stft(b, n_fft=n_fft, hop_length=hop))), 3, maxiter=60, seed=2).W)
    res = nt.cmfwisa(Zm, [3, 3], W_init=[WA, WB], W_fixed=True,
                     maxiter=60, tolerance=1e-12, seed=3)
    (HA, HB), (PA, PB) = res.H, res.P
    estA = (WA @ np.asarray(HA)) * np.asarray(PA)
    estB = (WB @ np.asarray(HB)) * np.asarray(PB)
    ya = np.asarray(nt.istft(estA, hop_length=hop, length=len(mix)))
    yb = np.asarray(nt.istft(estB, hop_length=hop, length=len(mix)))
    assert np.isrealobj(ya) and np.all(np.isfinite(ya + yb))

    def sdr(ref, sig):
        return 10 * np.log10(np.sum(ref ** 2) / np.sum((ref - sig) ** 2))

    assert sdr(a, ya) > sdr(a, mix) + 3.0
    assert sdr(b, yb) > sdr(b, mix) + 3.0


def test_griffinlim_spectral_convergence():
    """Phase reconstruction from magnitude alone: the reconstructed
    signal's STFT magnitude must approach the target (and beat the
    zero-iteration start by a wide margin)."""
    from nmf_toolbox_tpu.utils.audio import griffinlim
    sr = 8000
    t = np.arange(6000) / sr
    x = (0.7 * np.sin(2 * np.pi * 440 * t)
         + 0.3 * np.sin(2 * np.pi * 1250 * t + 0.4))
    n_fft, hop = 256, 64
    mag = np.abs(np.asarray(nt.stft(x, n_fft=n_fft, hop_length=hop)))

    def sc(y):
        M = np.abs(np.asarray(nt.stft(np.asarray(y), n_fft=n_fft,
                                      hop_length=hop)))
        return np.linalg.norm(M - mag) / np.linalg.norm(mag)

    y0 = griffinlim(mag, n_iter=0, hop_length=hop, length=len(x))
    y = griffinlim(mag, n_iter=48, hop_length=hop, length=len(x))
    assert y.shape == (len(x),) and np.isrealobj(np.asarray(y))
    # GL plateaus around ~0.07-0.11 spectral convergence on clean tones
    # (local-minimum character of the projections; librosa comparable)
    assert sc(y) < 0.12, sc(y)
    assert sc(y) < 0.3 * sc(y0)
    # an explicit key reproduces deterministically
    import jax
    yr = griffinlim(mag, n_iter=48, hop_length=hop, length=len(x),
                    key=jax.random.PRNGKey(7))
    assert sc(yr) < 0.15, sc(yr)
    # classic (momentum=0) is slower but still converges
    yc = griffinlim(mag, n_iter=48, hop_length=hop, momentum=0.0,
                    length=len(x))
    assert sc(yc) < 0.3, sc(yc)
    # more iterations keep improving
    y200 = griffinlim(mag, n_iter=200, hop_length=hop, length=len(x))
    assert sc(y200) < sc(y) + 1e-9


def test_griffinlim_batched_and_errors():
    from nmf_toolbox_tpu.utils.audio import griffinlim
    import pytest
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 2000))
    mag = np.abs(np.asarray(nt.stft(x, n_fft=128, hop_length=32)))
    y = griffinlim(mag, n_iter=8, hop_length=32, length=2000)
    assert y.shape == (2, 2000) and np.all(np.isfinite(np.asarray(y)))
    with pytest.raises(TypeError):
        griffinlim(mag.astype(np.complex64), n_iter=4)


def test_planes_boundary_matches_complex():
    """stft/istft planes=True: identical math, REAL boundary buffers
    (the real-boundary serving form; utils/audio.py docstrings)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=3000).astype(np.float32)
    Z = nt.stft(x, n_fft=256, hop_length=64)
    P = nt.stft(x, n_fft=256, hop_length=64, planes=True)
    P = np.asarray(P)
    assert not np.iscomplexobj(P) and P.shape == (2,) + Z.shape
    np.testing.assert_allclose(P[0], np.asarray(Z).real, atol=1e-6)
    np.testing.assert_allclose(P[1], np.asarray(Z).imag, atol=1e-6)
    y_c = np.asarray(nt.istft(Z, hop_length=64, length=len(x)))
    y_p = np.asarray(nt.istft(P, hop_length=64, length=len(x), planes=True))
    np.testing.assert_allclose(y_p, y_c, atol=1e-6)
    np.testing.assert_allclose(y_p, x, atol=1e-4)
    # batched leading dims keep working through the planar form
    xb = rng.normal(size=(3, 2000)).astype(np.float32)
    Pb = nt.stft(xb, n_fft=128, hop_length=32, planes=True)
    yb = nt.istft(Pb, hop_length=32, length=2000, planes=True)
    assert np.asarray(yb).shape == (3, 2000)
    np.testing.assert_allclose(np.asarray(yb), xb, atol=1e-4)


def test_istft_planes_validation():
    import pytest
    Z = nt.stft(np.zeros(1000, np.float32) + 0.1, n_fft=128, hop_length=32)
    with pytest.raises(ValueError):
        nt.istft(Z, hop_length=32, planes=True)          # complex input
    with pytest.raises(ValueError):
        nt.istft(np.zeros((3, 65, 10), np.float32), hop_length=32,
                 planes=True)                             # not 2 planes
