"""On-device STFT / iSTFT front-end for the audio workflows.

The reference toolbox factorizes spectrograms but leaves producing them
to MATLAB built-ins (`spectrogram`/`stft` — every cited application
paper, e.g. cnmf.m:107-113 / cmfwisa.m:88-91, operates on STFTs of
speech or music).  This module closes the loop on device: signal ->
complex STFT -> {nmf family, cmfwisa, encode engines} -> wiener masks
(utils/separation.py) -> iSTFT -> signal, with no host round trip in
the middle.

Conventions follow the de-facto Python standard (librosa-style):
periodic Hann window, ``center=True`` reflect-pads by n_fft//2 so frame
``t`` is centered on sample ``t*hop_length``, spectrograms are laid out
``(freq, time)`` = the toolbox's (m, n) orientation, and
``istft(stft(x))`` reconstructs ``x`` exactly (up to fp rounding)
whenever the window/hop pair satisfies NOLA — true for hann at any
hop <= n_fft//2.

Device notes: ``jnp.fft.rfft``/``irfft`` lower to XLA's native FFT; the
framing gather and the overlap-add scatter are one-time front-end ops,
off every solver's hot loop.  Both transforms are shape-static, jit
cleanly, and batch over any leading dims (channels, batch of clips),
so a serving pipeline can stft a whole batch in one dispatch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["hann_window", "stft", "istft", "magnitude", "griffinlim"]


def hann_window(n_fft: int, dtype=jnp.float32):
    """Periodic Hann window (the DFT-even form used for spectral
    analysis; scipy's ``get_window('hann', n, fftbins=True)``)."""
    # cos form keeps it exact at the endpoints: w[0] == 0.
    t = jnp.arange(n_fft, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * t / n_fft)


def _resolve_window(window, n_fft, dtype):
    if isinstance(window, str):
        if window == "hann":
            return hann_window(n_fft, dtype)
        if window in ("rect", "boxcar", "ones"):
            return jnp.ones((n_fft,), dtype)
        raise ValueError(f"unknown window {window!r}; pass 'hann', "
                         "'rect', or an (n_fft,) array")
    w = jnp.asarray(window, dtype)
    if w.shape != (n_fft,):
        raise ValueError(f"window has shape {w.shape}; need ({n_fft},)")
    return w


def _canon_window(window):
    """Window arrays are jit-static arguments of the transforms (the
    window's values shape the compiled program), and arrays are
    unhashable — canonicalize to a hashable tuple of floats."""
    if isinstance(window, (str, tuple)):
        return window
    return tuple(float(v) for v in np.asarray(window).reshape(-1))


@functools.partial(jax.jit, static_argnames=("n_fft", "hop_length",
                                             "window", "center"))
def _stft_jit(x, n_fft, hop_length, window, center):
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    if hop <= 0:
        raise ValueError(f"hop_length must be positive, got {hop}")
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        raise TypeError("stft expects a real signal; factorize complex "
                        "spectrograms directly instead")
    w = _resolve_window(window, n_fft, x.dtype)
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, pad, mode="reflect")
    length = x.shape[-1]
    if length < n_fft:
        raise ValueError(f"signal length {length} (after centering) is "
                         f"shorter than n_fft={n_fft}")
    n_frames = 1 + (length - n_fft) // hop
    # Frame via one gather: (n_frames, n_fft) index plane.  A one-time
    # front-end op — data volume is ~n_fft/hop x the signal.
    idx = (jnp.arange(n_frames) * hop)[:, None] + jnp.arange(n_fft)[None, :]
    frames = x[..., idx] * w  # (..., n_frames, n_fft)
    Z = jnp.fft.rfft(frames, axis=-1)  # (..., n_frames, n_fft//2+1)
    return jnp.swapaxes(Z, -1, -2)  # (..., freq, time)


@functools.partial(jax.jit, static_argnames=("n_fft", "hop_length",
                                             "window", "center"))
def _stft_planes_jit(x, n_fft, hop_length, window, center):
    Z = _stft_jit(x, n_fft, hop_length, window, center)
    return jnp.stack([Z.real, Z.imag])


def stft(x, n_fft: int = 512, hop_length: int | None = None,
         window="hann", center: bool = True, planes: bool = False):
    """Short-time Fourier transform of a real signal.

    ``x``: real array ``(..., length)``; leading dims batch.
    Returns the complex spectrogram ``(..., n_fft//2 + 1, n_frames)``
    — (freq, time), ready to feed ``cmfwisa`` directly or ``abs()`` it
    for the magnitude solvers.

    ``planes=True`` returns the REAL stack ``(2, ..., freq, time)`` of
    (real, imag) planes instead, computed in the same single program:
    the boundary then carries only real buffers (models/cmfwisa.py uses
    the same convention) — pair with ``istft(..., planes=True)`` and
    ``separation.separate_waveforms``.

    ``center=True`` (default) reflect-pads by ``n_fft // 2`` so frames
    are centered on multiples of ``hop_length`` and istft can
    reconstruct the full signal including the edges; ``center=False``
    frames the raw signal (first frame starts at sample 0) and istft
    then only reconstructs the NOLA-covered interior exactly.
    """
    if n_fft % 2 or n_fft < 2:
        # istft/griffinlim infer n_fft = 2*(F-1) from the row count; an
        # odd n_fft would silently reconstruct with the wrong size.
        raise ValueError(f"n_fft must be even and >= 2; got {n_fft}")
    fn = _stft_planes_jit if planes else _stft_jit
    return fn(x, n_fft, hop_length, _canon_window(window), center)


@functools.partial(jax.jit, static_argnames=("hop_length", "window",
                                             "center", "length"))
def _istft_jit(Z, hop_length, window, center, length):
    Z = jnp.asarray(Z)
    if Z.ndim < 2:
        raise ValueError(f"Z must be (..., freq, frames); got {Z.shape}")
    F, n_frames = Z.shape[-2], Z.shape[-1]
    n_fft = 2 * (F - 1)
    if n_fft <= 0:
        raise ValueError(f"need at least 2 frequency rows, got {F}")
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    real_dtype = jnp.zeros((), Z.dtype).real.dtype
    w = _resolve_window(window, n_fft, real_dtype)

    frames = jnp.fft.irfft(jnp.swapaxes(Z, -1, -2), n=n_fft, axis=-1)
    frames = frames * w  # synthesis window (..., n_frames, n_fft)

    out_len = n_fft + hop * (n_frames - 1)
    idx = ((jnp.arange(n_frames) * hop)[:, None]
           + jnp.arange(n_fft)[None, :]).reshape(-1)
    flat = frames.reshape(frames.shape[:-2] + (n_frames * n_fft,))
    x = jnp.zeros(frames.shape[:-2] + (out_len,), real_dtype)
    x = x.at[..., idx].add(flat)
    # NOLA normalization: overlap-added squared window.
    wsq = jnp.zeros((out_len,), real_dtype).at[idx].add(
        jnp.tile(w * w, n_frames))
    tiny = jnp.asarray(np.finfo(np.dtype(real_dtype)).tiny ** 0.5,
                       real_dtype)
    x = jnp.where(wsq > tiny, x / jnp.maximum(wsq, tiny), 0.0)
    if center:
        # Trim the analysis padding.  With an explicit length keep the
        # right-hand tail: the final frames extend past length-1 into
        # the reflect padding, and OLA/wsq is exact at every covered
        # sample — a symmetric trim would zero the last samples of any
        # signal whose length is not a multiple of hop.
        hi = out_len if length is not None else out_len - n_fft // 2
        x = x[..., n_fft // 2: hi]
    if length is not None:
        have = x.shape[-1]
        if have >= length:
            x = x[..., :length]
        else:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, length - have)]
            x = jnp.pad(x, pad)
    return x


@functools.partial(jax.jit, static_argnames=("hop_length", "window",
                                             "center", "length"))
def _istft_planes_jit(planes, hop_length, window, center, length):
    Z = jax.lax.complex(planes[0], planes[1])
    return _istft_jit(Z, hop_length, window, center, length)


def istft(Z, hop_length: int | None = None, window="hann",
          center: bool = True, length: int | None = None,
          planes: bool = False):
    """Inverse STFT by windowed overlap-add (Griffin & Lim LSEE-MSTFT:
    the least-squares signal for the given frames).

    ``Z``: complex spectrogram ``(..., n_fft//2 + 1, n_frames)`` as
    produced by :func:`stft` (n_fft is inferred as ``2*(F-1)``), or —
    with ``planes=True`` — the REAL ``(2, ..., freq, frames)`` stack of
    (real, imag) planes from ``stft(..., planes=True)``: the complex
    assembly then happens inside the program and only real buffers
    cross the boundary.
    ``length``: trim/zero-pad the output to this many samples (pass the
    original signal length to undo stft's frame quantization).

    Exact inverse of :func:`stft` for the same window/hop wherever the
    squared-window overlap-add is positive (NOLA); bins where it is
    ~zero (only the outermost samples of a ``center=False`` frame with
    w[0] == 0) are returned as 0.
    """
    if planes:
        Z = jnp.asarray(Z)
        if jnp.iscomplexobj(Z) or Z.ndim < 3 or Z.shape[0] != 2:
            raise ValueError("planes=True expects a real (2, ..., freq, "
                             f"frames) stack; got {Z.dtype} {Z.shape}")
        return _istft_planes_jit(Z, hop_length, _canon_window(window),
                                 center, length)
    return _istft_jit(Z, hop_length, _canon_window(window), center, length)


@functools.partial(jax.jit, static_argnames=("power",))
def _magnitude_planes_jit(Z, power):
    mag = jnp.sqrt(Z[0] * Z[0] + Z[1] * Z[1])
    return mag if power == 1.0 else mag ** power


def magnitude(Z, power: float = 1.0, planes: bool = False):
    """|Z|**power — the nonnegative spectrogram the magnitude solvers
    factorize (power=1 magnitude, 2 power spectrogram).

    ``planes=True``: ``Z`` is the real ``(2, ...)`` (real, imag) stack
    from ``stft(..., planes=True)`` — the magnitude is then computed
    without any complex buffer at the boundary, in ONE jitted dispatch."""
    Z = jnp.asarray(Z)
    if planes:
        if jnp.iscomplexobj(Z) or Z.shape[0] != 2:
            raise ValueError("planes=True expects a real (2, ...) stack; "
                             f"got {Z.dtype} {Z.shape}")
        return _magnitude_planes_jit(Z, float(power))
    mag = jnp.abs(Z)
    return mag if power == 1.0 else mag ** power


@functools.partial(jax.jit, static_argnames=("n_iter", "hop_length",
                                             "window", "momentum",
                                             "length"))
def _griffinlim_jit(mag, n_iter, hop_length, window, momentum, length,
                    key):
    F = mag.shape[-2]
    n_fft = 2 * (F - 1)
    hop = n_fft // 4 if hop_length is None else int(hop_length)
    cdt = jnp.complex128 if mag.dtype == jnp.float64 else jnp.complex64
    if key is None:
        key = jax.random.PRNGKey(0)
    ang = jax.random.uniform(key, mag.shape, mag.dtype, -jnp.pi, jnp.pi)
    angles = jnp.exp(1j * ang).astype(cdt)
    mom = jnp.asarray(momentum / (1.0 + momentum), mag.dtype)
    tiny = jnp.asarray(np.finfo(np.dtype(mag.dtype)).tiny, mag.dtype)

    def project(c):
        # istft -> stft round trip preserves the frame count for
        # center=True (hop * (n_frames - 1) samples come back).
        y = _istft_jit(c, hop, window, True, None)
        return _stft_jit(y, n_fft, hop, window, True)

    def body(_, carry):
        angles, tprev = carry
        rebuilt = project(mag * angles)
        t = rebuilt - mom * tprev
        angles = t / jnp.maximum(jnp.abs(t), tiny)
        return angles, rebuilt

    angles, _ = jax.lax.fori_loop(0, n_iter, body,
                                  (angles, jnp.zeros_like(angles)))
    return _istft_jit(mag * angles, hop, window, True, length)


def griffinlim(mag, n_iter: int = 32, hop_length: int | None = None,
               window="hann", momentum: float = 0.99,
               length: int | None = None, key=None):
    """Waveform from a MAGNITUDE spectrogram by Griffin-Lim phase
    reconstruction (fast accelerated variant, Perraudin 2013).

    The magnitude-NMF synthesis companion: a model magnitude
    ``W_s @ H_s`` has no phase of its own — when no mixture phase is
    available to reuse (utils/separation.py) and no phase model was fit
    (cmfwisa), this iterates stft(istft(.)) projections to find a
    signal whose STFT magnitude matches ``mag``.

    ``mag``: nonnegative (..., n_fft//2 + 1, n_frames) (stft layout;
    leading dims batch).  ``momentum``: 0 = classic Griffin & Lim 1984,
    0.99 (default) = accelerated.  ``key``: PRNG key for the random
    phase init; the default uses a FIXED internal key (deterministic) —
    random phases measurably out-converge a zero-phase start, whose
    all-frames-in-phase symmetry is a poor local minimum.  Runs as one
    compiled on-device loop (lax.fori_loop over the jitted
    stft/istft pair).  Returns the real waveform (..., length).
    """
    mag = jnp.asarray(mag)
    if jnp.iscomplexobj(mag):
        raise TypeError("griffinlim takes a magnitude (real, nonnegative) "
                        "spectrogram; complex STFTs already carry phase — "
                        "use istft directly")
    return _griffinlim_jit(mag, n_iter, hop_length, _canon_window(window),
                           momentum, length, key)
