"""Two-dimensional deconvolutional NMF (Schmidt & Morup 2006, NMF2D).

Beyond-reference solver: the reference's convolutive family shifts H in
TIME only (cnmf.m); NMF2D adds a second deconvolution axis — each basis
element may also shift DOWN the (log-)frequency axis, modelling pitch
transposition of a fixed spectral shape:

    V ~ Lambda = sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t)

with W (m, k, T) time-varying spectral shapes and H (k, n, P) per-pitch
activations.  On a log-frequency spectrogram one basis element then
covers every transposition of a note, which plain cnmf needs k x P
elements for.

Device-first structure: every 2-D-shifted product factors through the
cnmf ops via the adjoint identity shift_down(W, p)' @ X ==
W' @ shift_up(X, p) (ops/shift.py), so

  * reconstruction = sum_p shift_down_rows(conv_reconstruct(W, H_p), p)
    (ops/shift.conv_reconstruct_2d — also what nt.reconstruct dispatches
    to for a 3-D H)
  * the H gradient for pitch p = conv_wt_phi(W, shift_up(field, p))
  * the W gradient = per-pitch accumulated einsums of the up-shifted
    field against the (T, k, n) right-shifted H stack — no (P, m, n)
    field stack is ever formed

— the same batched-stacked-shift pattern as models/cnmf.py, one extra
axis.  Update order, the diagonal renormalization-correction terms, and
the cross-frame basis normalization follow cnmf's naive step EXACTLY,
so with pitch_len=1 the trajectories REDUCE to cnmf's for every
divergence without a ones-field shortcut (euclidean/IS/AB match
bit-for-bit; KL differs only by cnmf's reference no-shift quirk at
cnmf.m:220-224, which is a property of its unshifted ones field —
tests/test_nmf2d.py pins the reductions).

Sharding: V and H shard over the sample axis (time); the T time shifts
lower to halo exchanges exactly as in cnmf.  The feature axis stays
replicated — the P pitch shifts are then device-local (no vertical
halo), which is the right trade at NMF2D's scale (m is the STFT bin
count, thousands at most).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, merge_config, parse_cost_every,
                    resolve_dtype, uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.shift import (conv_wt_phi, conv_reconstruct_2d,
                         shift_up_rows, stack_shifts_right)
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    divergence: str
    alpha: float
    beta: float
    T: int
    P: int
    maxiter: int
    w_fixed: bool
    h_fixed: bool
    eps: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    cost_every: int = 1  # objective cadence (1 = reference semantics)


def _renorm(W, H, T):
    """Cross-frame basis normalization per element over (m, T) — cnmf's
    convention (ops/normalize.cross_frame_norm) so the pitch_len=1
    reduction is exact; the norm transfers into every pitch slice of H."""
    from ..ops.normalize import cross_frame_norm
    Wn, norms = cross_frame_norm(W, None, T, return_norms=True)
    Hn = None if H is None else H * norms[:, None, None]
    return Wn, Hn


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    a, b = spec.alpha, spec.beta
    T, P = spec.T, spec.P
    dual = a == 0.0
    power = (1.0 / b) if dual else (None if a == 1.0 else 1.0 / a)
    ce = int(spec.cost_every)
    # cost_every tail (ops/loop.cost_cadence): the objective is the
    # THIRD full 2-D reconstruction of the iteration (the W and H
    # updates each build their own); skipped iterations drop it plus
    # the divergence pass.
    finish = looplib.cost_cadence(ce, spec.maxiter)

    @jax.jit
    def solve(V, W0, H0, wsp, hsp, tolerance):
        eps = jnp.asarray(spec.eps, V.dtype)
        dt = V.dtype
        nv = None if spec.valid is None else spec.valid[1]
        mask = region_mask(V.shape, spec.valid)

        def reconstruct2d(W, H):
            return conv_reconstruct_2d(W, H, nv)

        def w_grad(Phi, H):
            # A[m, k, t] = sum_p shift_up(Phi, p) @ shift_right(H_p, t)'
            # accumulated per pitch so no (P, m, n) field stack is ever
            # formed (the same economy cnmf applies to its (T, m, n)
            # analog — see ops/shift.conv_wt_phi).
            out = None
            for p in range(P):
                term = jnp.einsum(
                    "mn,tkn->mkt", shift_up_rows(Phi, p),
                    stack_shifts_right(H[:, :, p], T, nv),
                    preferred_element_type=dt)
                out = term if out is None else out + term
            return out

        def step(carry, i):
            W, H = carry[0], carry[1]  # W: (m, k, T), H: (k, n, P)
            if not spec.w_fixed:
                Lam = reconstruct2d(W, H)
                phi_neg, phi_pos, _ = dv.ab_fields(V, Lam, a, b, mask=mask)
                A = w_grad(phi_neg, H)
                B = w_grad(phi_pos, H)
                # cnmf's diagonal renormalization-correction terms
                dneg = jnp.sum(W * B, axis=0)
                dpos = jnp.sum(W * A, axis=0)
                neg = dv.apply_power(A + W * dneg[None], power)
                pos = dv.apply_power(B + W * dpos[None], power)
                W = W * (neg / jnp.maximum(pos + wsp[None, :, None], eps))
                W, _ = _renorm(W, None, T)
            if not spec.h_fixed:
                Lam = reconstruct2d(W, H)
                phi_neg, phi_pos, _ = dv.ab_fields(V, Lam, a, b, mask=mask)
                # per pitch: conv_wt_phi of the p-up-shifted field
                gneg = jnp.stack([conv_wt_phi(W, shift_up_rows(phi_neg, p))
                                  for p in range(P)], axis=2)  # (k, n, P)
                gpos = jnp.stack([conv_wt_phi(W, shift_up_rows(phi_pos, p))
                                  for p in range(P)], axis=2)
                gneg = dv.apply_power(gneg, power)
                gpos = dv.apply_power(gpos, power)
                H = H * (gneg / jnp.maximum(gpos + hsp[:, None, None], eps))
            def cost_fn(W=W, H=H):
                c = dv.cost(spec.divergence, V, reconstruct2d(W, H), a, b,
                            mask=mask)
                return c + (jnp.sum(wsp * jnp.sum(jnp.abs(W), axis=(0, 2)))
                            + jnp.sum(hsp * jnp.sum(jnp.abs(H), axis=(1, 2))))
            return finish((W, H), carry, i, cost_fn)

        return looplib.run(step, looplib.cadence_state((W0, H0), ce, dt),
                           spec.maxiter, tolerance,
                           cost_dtype=V.dtype)
    return solve


def nmf2d(V, num_basis_elems: int, context_len: int, pitch_len: int,
          config: dict | None = None, **kwargs):
    """2-D deconvolutional NMF:
    V ~ sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t).

    Beyond-reference (Schmidt & Morup 2006); the natural log-frequency
    generalization of cnmf — ``pitch_len=1`` IS cnmf (trajectory-pinned,
    tests/test_nmf2d.py).  Single source.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' + alpha/
    beta incl. the alpha=0 dual — the cnmf family, all paper-correct
    shifted fields), W_init (m, k, T), H_init (k, n, P),
    W_sparsity/H_sparsity (L1), W_fixed/H_fixed, maxiter (100),
    tolerance (1e-3), seed, dtype, eps, mesh (samples axis; the feature
    axis stays replicated so pitch shifts are device-local),
    cost_every (int, default 1: evaluate the objective every N
    iterations — the objective is the iteration's THIRD full 2-D
    reconstruction, so skipped iterations drop ~1/3 of the T*P-shift
    matmul work; update math unchanged, tolerance check coarsens to
    N-iteration windows, ops/loop.cost_cadence).
    Returns Result with W (m, k, T), H (k, n, P), cost.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    if V.ndim != 2:
        raise ValueError(f"nmf2d expects a 2-D V; got {V.shape}")
    m, n = V.shape
    T, P = int(context_len), int(pitch_len)
    if T < 1 or P < 1:
        raise ValueError(f"context_len and pitch_len must be >= 1; got "
                         f"({T}, {P})")
    if P > m:
        raise ValueError(f"pitch_len {P} exceeds the feature count {m}")
    if isinstance(num_basis_elems, (list, tuple)):
        raise TypeError("nmf2d is single-source; concatenate bases "
                        "externally for multi-source workflows")
    k = int(num_basis_elems)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0),
                               cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")

    w_sp = max(float(cfg.get("W_sparsity") or 0.0), 0.0)
    h_sp = max(float(cfg.get("H_sparsity") or 0.0), 0.0)
    w_fx = bool(cfg.get("W_fixed", False))
    h_fx = bool(cfg.get("H_fixed", False))
    maxiter, tolerance, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        from ..ops.normalize import unit_l2_columns
        W0 = unit_l2_columns(uniform_init(kw, (m, k, T), dtype))
    W0 = jnp.asarray(W0, dtype)
    if W0.shape != (m, k, T):
        raise ValueError(f"W_init has shape {W0.shape}, expected {(m, k, T)}")
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(kh, (k, n, P), dtype)
    H0 = jnp.asarray(H0, dtype)
    if H0.shape != (k, n, P):
        raise ValueError(f"H_init has shape {H0.shape}, expected {(k, n, P)}")
    # Entry normalization with norm transfer into H (cnmf.m:157-166
    # convention so the pitch_len=1 reduction is exact).
    W0, H0 = _renorm(W0, H0, T)

    wsp = jnp.full((k,), w_sp, dtype)
    hsp = jnp.full((k,), h_sp, dtype)

    mesh = cfg.get("mesh")
    _, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        valid = (m, n)  # feature axis is never padded for nmf2d
        V = pad_axes(V, {1: pad_n})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "nmf2d", V=V, W=W0, H=H0)

    spec = _Spec(div, alpha, beta, T, P, maxiter, w_fx, h_fx, eps, valid,
                 parse_cost_every(cfg))
    out = _build_solver(spec)(V, W0, H0, wsp, hsp,
                              jnp.asarray(tolerance, dtype))
    W, H = out.state[0], out.state[1]
    if valid is not None:
        H = H[:, :n]
    return Result(
        fields=("W", "H", "cost"),
        W=W, H=H,
        cost=looplib.trim_cost(out, maxiter),
        n_iters=int(out.n_iters), converged=bool(out.stopped),
    )
