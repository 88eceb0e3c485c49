"""Wiener-filter source separation from NMF factors.

The reference stops at the factorization: its separation story is
"reconstruct each source as W_i @ H_i" (the per-source model structure
of nmf.m:136-137 multi-source cells and cmfwisa.m:164-169).  Direct
reconstruction discards the part of the mixture the models did not fit,
so the estimates neither sum to the mixture nor use its phase.  The
standard practice on top of any NMF separation (Fevotte et al. 2009 -
the IS-NMF paper's Wiener reconstruction; used by every NMF audio
system since) is soft masking:

    mask_i = (W_i H_i)^p / sum_j (W_j H_j)^p,     est_i = mask_i * V

With p=2 this is the Wiener filter (power-spectrogram ratios); p=1 is
ratio masking on magnitudes.  The estimates sum EXACTLY to V by
construction, and when V is the complex STFT the masks (real) reuse the
mixture phase - the consistent way to get listenable sources out of a
magnitude factorization.

Device notes: masking is a pure elementwise field over (S, m, n) - one
fused XLA kernel, no matmul.  ``separate`` jits cleanly and accepts
device arrays (e.g. ``nmf_encode(..., device_output=True)`` factors) so
an encode -> separate serving pipeline never leaves the chip.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import EPS

__all__ = ["wiener_masks", "separate", "separate_waveforms"]


def _stack_models(W, H):
    """Per-source reconstructions (S, m, n) from lists of (W_i, H_i).

    Each W_i may be 2-D (m, k_i) or a convolutive 3-D (m, k_i, T) basis
    — reconstruction goes through ops.shift.reconstruct, so cnmf-family
    factors (e.g. cnmf_encode output) separate directly."""
    from ..ops.shift import reconstruct
    if not isinstance(W, (list, tuple)) or not isinstance(H, (list, tuple)):
        raise TypeError(
            "W and H must be lists of per-source factors (the multi-source "
            "output shape of nmf/cmfwisa, or any [W_i], [H_i] pairing)")
    if len(W) != len(H) or not W:
        raise ValueError(f"need matching non-empty factor lists; got "
                         f"{len(W)} bases and {len(H)} encodings")
    return jnp.stack([reconstruct(jnp.asarray(Wi), jnp.asarray(Hi))
                      for Wi, Hi in zip(W, H)])


def wiener_masks(W, H, power: float = 2.0, eps: float = EPS):
    """Soft masks (S, m, n) from per-source factor lists.

    ``power``: exponent on the model magnitudes (2.0 = Wiener / power
    ratios, 1.0 = magnitude ratios).  Masks are non-negative and sum to
    one over sources at every bin (uniform 1/S where every model is
    zero, so the decomposition stays exact).
    """
    fields = jnp.abs(_stack_models(W, H)) ** power
    total = jnp.sum(fields, axis=0, keepdims=True)
    S = fields.shape[0]
    # Where all models vanish the ratio is 0/0; share the bin equally so
    # sum_i est_i == V still holds exactly.
    return jnp.where(total > eps, fields / jnp.maximum(total, eps),
                     1.0 / S)


def separate(V, W, H, power: float = 2.0, eps: float = EPS):
    """Per-source estimates (S, m, n) with sum_i est_i == V exactly.

    ``V``: the mixture the factors were fit to - magnitude or complex
    STFT (complex V reuses the mixture phase per source, since the masks
    are real).  ``W``/``H``: lists of per-source factors - the
    multi-source output of ``nmf``/``cmfwisa`` directly, or slices of a
    single model's columns grouped by source.  Returns a stacked jax
    array; index ``out[i]`` for source i.
    """
    V = jnp.asarray(V)
    masks = wiener_masks(W, H, power=power, eps=eps)
    if V.shape != masks.shape[1:]:
        raise ValueError(f"V has shape {V.shape}; factors reconstruct "
                         f"{masks.shape[1:]}")
    return masks * V[None]


# separate() is elementwise over static shapes: jit is free and keeps the
# encode -> separate serving path on device.
separate = jax.jit(separate, static_argnames=("power",))


@functools.partial(jax.jit, static_argnames=("power", "hop_length",
                                             "window", "center", "length"))
def _separate_waveforms_jit(planes, W, H, power, hop_length, window,
                            center, length):
    from .audio import _istft_jit
    masks = wiener_masks(W, H, power=power)       # (S, m, n) real
    Z = jax.lax.complex(planes[0], planes[1])     # complex stays inside
    est = masks.astype(planes.dtype) * Z[None]
    return _istft_jit(est, hop_length, window, center, length)


def separate_waveforms(Z, W, H, *, hop_length=None, window="hann",
                       center=True, length=None, power: float = 2.0):
    """Serving decode in ONE program: Wiener masks + mixture-phase reuse
    + iSTFT, waveforms out.

    ``Z``: the mixture's complex STFT ``(freq, frames)`` — or, to keep
    every boundary buffer real, the ``(2, freq, frames)`` plane stack from
    ``stft(..., planes=True)``.  ``W``/``H``: per-source factor lists as
    in :func:`separate`.  Returns the stacked real waveforms
    ``(S, length)``.

    Compared to ``separate`` + ``istft`` this fuses the whole decode
    into a single dispatch (masks are elementwise, the iSTFT batches
    over the source axis) and keeps every boundary buffer real — the
    shape a production encode->decode loop wants on the device.
    """
    Z = jnp.asarray(Z)
    if jnp.iscomplexobj(Z):
        planes = jnp.stack([Z.real, Z.imag])
    else:
        if Z.ndim < 3 or Z.shape[0] != 2:
            raise ValueError("real Z must be a (2, freq, frames) plane "
                             f"stack; got {Z.shape}")
        planes = Z
    W = tuple(jnp.asarray(w) for w in (W if isinstance(W, (list, tuple))
                                       else [W]))
    H = tuple(jnp.asarray(h) for h in (H if isinstance(H, (list, tuple))
                                       else [H]))
    # Same explicit mismatch message separate() gives; without it a
    # wrong-hop H surfaces as a cryptic XLA broadcast error inside jit.
    rec = jax.eval_shape(lambda w, h: wiener_masks(w, h), W, H)
    if planes.shape[1:] != rec.shape[1:]:
        raise ValueError(f"Z has shape {tuple(planes.shape[1:])}; factors "
                         f"reconstruct {tuple(rec.shape[1:])}")
    from .audio import _canon_window
    return _separate_waveforms_jit(planes, W, H, power, hop_length,
                                   _canon_window(window), center, length)
