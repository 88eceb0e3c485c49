"""Convolutive NMF (Smaragdis 2007) with unified AB-divergence updates.

Accelerator re-design of cnmf.m.  The reference's per-shift t-loops
(cnmf.m:180-195, 216-227) become batched matmuls over stacked shifts
(ops/shift.py): the W gradient for all T frames is ONE einsum against the
(T, k, n) stack of right-shifted H's, and the H gradient accumulation
uses the identity W_t' @ shift_left(Phi, t) == shift_left(W_t' @ Phi, t)
so no (T, m, n) tensor is ever formed.

Multi-source cell arrays concatenate along the basis axis; every update
(including the diagonal normalization-correction terms and the
cross-frame Frobenius renormalization of cnmf.m:161-165,196-199) is
column-local, so the hot loop has no per-source logic.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, as_list, merge_config,
                    parse_cost_every, per_column,
                    fixed_col_mask, promote_inits, promote_per_source,
                    resolve_dtype, source_blocks, unwrap_sources,
                    uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.normalize import cross_frame_norm, unit_l2_columns
from ..ops.gram import conv_cross_grams_h, conv_cross_grams_w
from ..ops.masking import region_mask
from ..ops.shift import (conv_phi_ht, conv_reconstruct, conv_wt_phi,
                         shift_left, stack_shifts_right)
from ..parallel import (apply_placements, pad_axes, plan_padding,
                        prepare_weights)


class _Spec(NamedTuple):
    divergence: str      # canonical name (drives the KL no-shift special case)
    alpha: float
    beta: float
    context_len: int
    maxiter: int
    w_fixed: tuple
    h_fixed: tuple
    blocks: tuple
    eps: float
    method: str          # 'gram' (euclidean only) | 'naive'
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    cost_every: int = 1  # objective cadence (1 = reference semantics)


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    a, b = spec.alpha, spec.beta
    T = spec.context_len
    dual = a == 0.0
    power = (1.0 / b) if dual else (None if a == 1.0 else 1.0 / a)
    ks = [bb - aa for aa, bb in spec.blocks]
    w_mask = fixed_col_mask(spec.w_fixed, ks)
    h_mask = fixed_col_mask(spec.h_fixed, ks)
    w_any = not all(spec.w_fixed)
    h_any = not all(spec.h_fixed)
    w_all_free = not any(spec.w_fixed)
    h_all_free = not any(spec.h_fixed)
    kl = spec.divergence == "kl"
    ce = int(spec.cost_every)
    # cost_every tail (ops/loop.cost_cadence): on skipped iterations the
    # naive path drops the objective's full convolutive reconstruction
    # (T shifted (m, k) x (k, n) matmuls) + divergence pass, and the
    # Gram path drops the post-update WW/HH cross-Gram recomputation.
    finish = looplib.cost_cadence(ce, spec.maxiter)

    @jax.jit
    def solve(V, W0, H0, wsp, hsp, tolerance, Mw=None):
        eps = jnp.asarray(spec.eps, V.dtype)
        dt = V.dtype
        v_sq = jnp.sum(V * V)
        # Mesh padding: the shift spill past the true n must be truncated
        # (stack_shifts_right n_valid) and the nonlinear fields masked.
        nv = None if spec.valid is None else spec.valid[1]
        mask = region_mask(V.shape, spec.valid)

        def cross_grams_h(H):
            return conv_cross_grams_h(stack_shifts_right(H, T, nv))

        def gram_step(carry, i):
            # Euclidean-only Gram form: the convolutive reconstruction is
            # never materialized.  Per iteration only TWO batched matmuls
            # touch V (conv_phi_ht(V, H) and conv_wt_phi(W, V)); the
            # V_hat-dependent terms are assembled from (T, T, k, k)
            # cross-Grams.  Mathematically identical to cnmf.m:175-251.
            W, H = carry[0], carry[1]
            if w_any:
                HH = cross_grams_h(H)                    # HH[s, t]
                A = conv_phi_ht(V, H, T, nv)             # (m, k, T) [big]
                # B[:, :, t] = V_hat @ H^(t)' = sum_s W_s HH[s, t]
                B = jnp.einsum("mks,stkl->mlt", W, HH,
                               preferred_element_type=dt)
                dneg = jnp.sum(W * B, axis=0)
                dpos = jnp.sum(W * A, axis=0)
                neg = A + W * dneg[None]
                pos = B + W * dpos[None]
                Wn = W * (neg / jnp.maximum(pos + wsp[None, :, None], eps))
                Wn, _ = cross_frame_norm(Wn, None, T)
                W = Wn if w_all_free else jnp.where(w_mask[None, :, None], W, Wn)
            gneg = conv_wt_phi(W, V)                     # (k, n) [big]
            if h_any:
                WW = conv_cross_grams_w(W)
                Hs = stack_shifts_right(H, T, nv)
                gpos = jnp.zeros_like(gneg)
                for t in range(T):
                    gpos = gpos + shift_left(
                        jnp.einsum("skl,sln->kn", WW[t], Hs,
                                   preferred_element_type=dt), t)
                Hn = H * (gneg / jnp.maximum(gpos + hsp[:, None], eps))
                H = Hn if h_all_free else jnp.where(h_mask[:, None], H, Hn)
            def cost_fn(W=W, H=H, gneg=gneg):
                # cost with the UPDATED factors, all in Gram space:
                # <V, conv(W, H)> = <conv_wt_phi(W, V), H>.
                WW = conv_cross_grams_w(W)
                HH = cross_grams_h(H)
                c = jnp.maximum(  # clamp: see ops/gram.euclidean_cost_gram
                    0.5 * (v_sq - 2.0 * jnp.sum(gneg * H)
                           + jnp.sum(WW * HH)), 0.0)
                return c + (jnp.sum(wsp * jnp.sum(jnp.abs(W), axis=(0, 2)))
                            + jnp.sum(hsp * jnp.sum(jnp.abs(H), axis=1)))
            return finish((W, H), carry, i, cost_fn)

        def step(carry, i):
            W, H = carry[0], carry[1]  # W: (m, k, T), H: (k, n)
            # With per-entry weights the KL ones-field shortcuts below do
            # not apply (the positive field becomes the weight matrix and
            # must be shifted like any other field — the paper-correct
            # form; the reference's no-shift quirk at cnmf.m:220-224 is a
            # property of the position-independent ones field only).
            kl_fast = kl and Mw is None
            if w_any:
                V_hat = conv_reconstruct(W, H, nv)
                phi_neg, phi_pos, _ = dv.ab_fields(V, V_hat, a, b, mask=mask,
                                                   weights=Mw)
                # One batched matmul per field against all T shifted H's
                # (cnmf.m:180-195).
                A = conv_phi_ht(phi_neg, H, T, nv)  # (m, k, T)
                if kl_fast:
                    # Phi_pos == ones: ones(m,n) @ shift_right(H,t)' is a
                    # broadcast of the shifted rowsums sum(H[:, :n-t]) —
                    # no m-by-n matmul needed.
                    csum = jnp.cumsum(H[:, ::-1], axis=1)[:, ::-1]
                    # the ones field spans the TRUE n of a padded problem:
                    # rs[t] = sum(H[:, :n_true - t]) (H's pads are zero)
                    n_ = H.shape[1] if nv is None else nv
                    rs = jnp.stack([csum[:, 0] if t == 0 else
                                    csum[:, 0] - csum[:, n_ - t]
                                    for t in range(T)], axis=1)  # (k, T)
                    B = jnp.broadcast_to(rs[None], (V.shape[0],) + rs.shape)
                    dneg = jnp.sum(W, axis=0) * rs
                else:
                    B = conv_phi_ht(phi_pos, H, T, nv)  # (m, k, T)
                    dneg = jnp.sum(W * B, axis=0)   # diag(Hs Phi_pos' W_t), (k, T)
                dpos = jnp.sum(W * A, axis=0)
                neg = dv.apply_power(A + W * dneg[None], power)
                pos = dv.apply_power(B + W * dpos[None], power)
                Wn = W * (neg / jnp.maximum(pos + wsp[None, :, None], eps))
                # Cross-frame renorm per basis element (cnmf.m:196-199).
                Wn, _ = cross_frame_norm(Wn, None, T)
                W = Wn if w_all_free else jnp.where(w_mask[None, :, None], W, Wn)
            if h_any:
                V_hat = conv_reconstruct(W, H, nv)
                phi_neg, phi_pos, _ = dv.ab_fields(V, V_hat, a, b, mask=mask,
                                                   weights=Mw)
                gneg = conv_wt_phi(W, phi_neg)      # (k, n)
                if kl_fast:
                    # KL special case: V_pos is NOT shifted (cnmf.m:220-224),
                    # and Phi_pos == ones: sum_t W_t' @ ones(m, n) is a
                    # broadcast of sum(W) over (m, t).
                    gpos = jnp.broadcast_to(
                        jnp.sum(W, axis=(0, 2))[:, None], gneg.shape)
                else:
                    gpos = conv_wt_phi(W, phi_pos)
                gneg = dv.apply_power(gneg, power)
                gpos = dv.apply_power(gpos, power)
                Hn = H * (gneg / jnp.maximum(gpos + hsp[:, None], eps))
                H = Hn if h_all_free else jnp.where(h_mask[:, None], H, Hn)
            def cost_fn(W=W, H=H):
                # the objective's OWN reconstruction — the only consumer
                # of this T-shift matmul chain; skipped iterations under
                # cost_every > 1 drop it entirely
                c = dv.cost(spec.divergence, V, conv_reconstruct(W, H, nv),
                            a, b, mask=mask, weights=Mw)
                return c + (jnp.sum(wsp * jnp.sum(jnp.abs(W), axis=(0, 2)))
                            + jnp.sum(hsp * jnp.sum(jnp.abs(H), axis=1)))
            return finish((W, H), carry, i, cost_fn)

        body = gram_step if spec.method == "gram" else step
        return looplib.run(body, looplib.cadence_state((W0, H0), ce, dt),
                           spec.maxiter, tolerance,
                           cost_dtype=V.dtype)
    return solve


def cnmf(V, num_basis_elems, context_len: int,
         config: dict | None = None, **kwargs):
    """Convolutive NMF: V ~ sum_t W[:, :, t] @ shift_right(H, t).

    Parameter surface mirrors cnmf.m:17-80: divergence/alpha/beta
    (euclidean, kl, is are mapped onto AB (alpha, beta) — cnmf.m:137-147),
    W_init (m, k, T), H_init, W_sparsity/H_sparsity, W_fixed/H_fixed,
    maxiter, tolerance.  Returns Result as (W, H, cost).

    Extra: ``weights`` ((m, n) nonnegative per-entry weights).  NOTE for
    KL: the weighted solver always uses the paper-correct SHIFTED
    positive field, whereas the unweighted KL path reproduces the
    reference's no-shift boundary quirk (cnmf.m:220-224, valid only for
    the position-independent ones field) — so ``weights=ones`` matches
    the unweighted run exactly for euclidean/IS/AB but differs near the
    right time boundary for KL.

    ``cost_every`` (int, default 1): evaluate the objective every N
    iterations — the update math is unchanged (bit-exact on CPU;
    tests/test_cost_every.py), the tolerance check coarsens to N-iteration
    windows (ops/loop.cost_cadence).  On an accelerator the cadence variant
    is a different compiled program and the cond boundary blocks XLA from
    fusing the objective with the update fields, so float32 matmul rounding
    may differ and compound through the MU chain, at the order of the
    default-precision matmul's own deviation from the float64 oracle.  The
    convolutive objective is expensive (a full T-shift reconstruction plus
    the divergence pass for the naive path; the WW/HH cross-Gram
    recomputation for the Gram path) and feeds only the stopping rule.  At
    small shapes (BASELINE #3's 513x10k r64 T8) the while-loop's per-step
    cond overhead can offset the saving; the batched ``cnmf_encode`` engine
    is cond-free.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    T = int(context_len)

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0), cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")

    w_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)]
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    w_fx = tuple(bool(x) for x in promote_per_source(cfg.get("W_fixed"), S, "W_fixed", False))
    h_fx = tuple(bool(x) for x in promote_per_source(cfg.get("H_fixed"), S, "H_fixed", False))
    maxiter, tolerance, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    if w_list is None:
        # rand (m, k, T) with per-frame unit-L2 columns
        # (ValidateParameters.m:82-88).
        keys = jax.random.split(kw, S)
        w_list = [unit_l2_columns(uniform_init(kk, (m, k, T), dtype))
                  for kk, k in zip(keys, ks)]
        w_was_seq = was_seq
    if h_list is None:
        keys = jax.random.split(kh, S)
        w_list_h = [uniform_init(kk, (k, n), dtype) for kk, k in zip(keys, ks)]
        h_list = w_list_h
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if np.shape(w) != (m, k, T):
            raise ValueError(f"W_init[{s}] has shape {np.shape(w)}, expected {(m, k, T)}")
        if np.shape(h) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {np.shape(h)}, expected {(k, n)}")

    W0 = jnp.concatenate([jnp.asarray(w, dtype) for w in w_list], axis=1)
    H0 = jnp.concatenate([jnp.asarray(h, dtype) for h in h_list], axis=0)
    # Cross-frame init normalization with norm transfer into H
    # (cnmf.m:157-166).
    W0, H0 = cross_frame_norm(W0, H0, T)

    wsp = per_column(w_sp, ks, dtype)
    hsp = per_column(h_sp, ks, dtype)

    weights = cfg.get("weights")

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "cnmf", V=V, W=W0, H=H0)
    weights = prepare_weights(weights, dtype, (m, n), mesh, "cnmf",
                              pad_m, pad_n, valid)

    method = cfg.get("method", "auto")
    euclid = div == "euclidean" and alpha == 1.0 and beta == 1.0
    if weights is not None:
        # weighted fields need the materialized reconstruction
        if method == "auto":
            method = "naive"
        elif method != "naive":
            raise ValueError("weights= requires method='naive' (the "
                             "weighted fields are nonlinear in the "
                             "reconstruction)")
    if method == "auto":
        method = "gram" if euclid else "naive"
    if method == "gram" and not euclid:
        raise ValueError("method='gram' is only valid for the euclidean divergence")

    spec = _Spec(div, alpha, beta, T, maxiter, w_fx, h_fx, blocks, eps, method,
                 valid, parse_cost_every(cfg))
    solve = _build_solver(spec)
    tol = jnp.asarray(tolerance, dtype)
    if weights is None:
        out = solve(V, W0, H0, wsp, hsp, tol)
    else:
        out = solve(V, W0, H0, wsp, hsp, tol, weights)
    W, H = out.state[0], out.state[1]
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(
        fields=("W", "H", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        cost=looplib.trim_cost(out, maxiter),
        n_iters=int(out.n_iters), converged=bool(out.stopped),
    )
