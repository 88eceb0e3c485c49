"""Convolutive NMF with Hoyer sparseness constraints (Ramanarayanan 2013).

Accelerator re-design of cnmfsc.m — the most stateful solver in the
toolbox.  Reproduced semantics (validated against a literal NumPy oracle):

* double-buffered basis: updates read W0 and write W, committed at the
  end of each iteration (cnmfsc.m:94-96,266) — including the quirk that
  the initial sparsity projection writes W but not W0 (cnmfsc.m:106-110),
  and that the H-phase row-renorm scales W0 only (cnmfsc.m:204-209);
* per-frame stepsizes for the W line searches (cnmfsc.m:147);
* the W line-search objective evaluates a 2-D reconstruction Wnew @ H
  (cnmfsc.m:235), and each frame's begobj is the previous frame's
  accepted objective;
* the non-sparse W branch updates V_hat incrementally with a clamp:
  V_hat = max(V_hat + (W_t - W0_t) H_shifted, 0) (cnmfsc.m:262);
* the non-sparse H MU guard is (pos + eps), not max(pos, eps)
  (cnmfsc.m:202).

Device-first details: all line-search trial objectives are evaluated in Gram
form.  With the basis frozen, 0.5||V - sum_t W_t H^(t)||^2 reduces to
cross-Grams WW[t,s] = W_t'W_s against shifted-H Grams — O(T^2 k^2 n) per
trial instead of a T-batched m-by-n reconstruction.  The only full-size
(m x n x k-shaped) contractions per outer iteration are the two batched
matmuls against V (conv_wt_phi / conv_phi_ht) plus the literal
incremental-V_hat branch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import common_scalars, ingest_rescaled, Result, merge_config, \
    resolve_dtype
from ..ops import loop as looplib
from ..ops.projection import hoyer_l1_target, project_columns
from ..ops.shift import (conv_phi_ht, conv_reconstruct, conv_wt_phi,
                         shift_left, stack_shifts_right)
from ..ops.gram import conv_cross_grams_w as _cross_grams_w
from ..ops.gram import conv_cross_grams_h as _cross_grams_h
from ..ops.linesearch import make_search, resolve_width
from ..parallel import apply_placements, pad_axes, plan_padding



class _Spec(NamedTuple):
    context_len: int
    maxiter: int
    w_sparse: bool
    h_sparse: bool
    w_fixed: bool
    h_fixed: bool
    eps: float
    l1_w: float
    l1_h: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    ls_width: int = 0    # 0 = sequential halving; >0 = parallel backtracking


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    T = spec.context_len

    @jax.jit
    def solve(V, W0_init, W_init, H0, tolerance, st_w0, st_h0):
        dt = V.dtype
        eps = jnp.asarray(spec.eps, dt)
        one = jnp.ones((), dt)
        v_sq = jnp.sum(V * V)

        # Mesh padding: shift spill past the true n is truncated in every
        # stacked-shift/reconstruction below; Hoyer projections run with
        # the TRUE vector lengths (ops/projection.py).
        mv, nv = spec.valid if spec.valid is not None else (None, None)
        _line_search_obj = make_search(spec.ls_width)

        def proj_rows(H):
            return project_columns(H.T, spec.l1_h, one, valid=nv)[0].T

        def proj_cols(W2d):
            return project_columns(W2d, spec.l1_w, one, valid=mv)[0]

        def conv_cost(W, H):
            r = V - conv_reconstruct(W, H, nv)
            return 0.5 * jnp.sum(r * r)

        def step(carry, i):
            W0, W, H, step_w, step_h, prev_cost = carry
            term = jnp.asarray(False)

            # ---- H phase (cnmfsc.m:156-211) — gradients read W0, but the
            # V_hat entering this phase was reconstructed from the
            # *committed* W (cnmfsc.m:152/269; W differs from W0 only in
            # iteration 1 when the init projection wrote W alone) ----
            if not spec.h_fixed:
                neg = conv_wt_phi(W0, V)  # sum_t W0_t' V<-t (cnmfsc.m:161-163)
                Hs = stack_shifts_right(H, T, nv)
                WW0 = _cross_grams_w(W0)
                # pos = sum_t W0_t' (conv(W,H))<-t via cross-Grams W0_t' W_s
                WX = jnp.einsum("mkt,mls->tskl", W0, W,
                                preferred_element_type=dt)
                pos = jnp.zeros_like(neg)
                for t in range(T):
                    pos = pos + shift_left(
                        jnp.einsum("skl,sln->kn", WX[t], Hs,
                                   preferred_element_type=dt), t)
                if spec.h_sparse:
                    dH = pos - neg
                    def obj_h(Hnew):
                        Hns = stack_shifts_right(Hnew, T, nv)
                        sq = jnp.sum(WW0 * _cross_grams_h(Hns))
                        return 0.5 * (v_sq - 2.0 * jnp.sum(neg * Hnew) + sq)
                    H1, step_h1, under_h, _ = _line_search_obj(
                        obj_h, H, dH, step_h, proj_rows, prev_cost)
                    H, step_h = H1, step_h1
                    term = term | under_h
                else:
                    H = H * (neg / (pos + eps))  # (pos + eps)! cnmfsc.m:202
                    norms = jnp.sqrt(jnp.sum(H * H, axis=1))
                    H = H / norms[:, None]
                    W0 = W0 * norms[None, :, None]  # scales W0 only (cnmfsc.m:207-209)

            # ---- W phase (cnmfsc.m:213-265) ----
            if not spec.w_fixed:
                Hs = stack_shifts_right(H, T, nv)
                if spec.w_sparse:
                    HH = _cross_grams_h(Hs)           # HH[s, t] = Hs[s] Hs[t]'
                    VHt_all = conv_phi_ht(V, H, T, nv)  # (m, k, T)
                    WW0 = _cross_grams_w(W0)
                    lin0 = jnp.sum(VHt_all * W0)
                    begobj = 0.5 * (v_sq - 2.0 * lin0 + jnp.sum(WW0 * HH))
                    G00 = HH[0, 0]
                    VHt0 = VHt_all[:, :, 0]

                    def obj_2d(Wnew):  # 0.5||V - Wnew @ H||^2 (cnmfsc.m:235)
                        return 0.5 * (v_sq - 2.0 * jnp.sum(VHt0 * Wnew)
                                      + jnp.sum((Wnew.T @ Wnew) * G00))

                    Wprev = None
                    for t in range(T):
                        if t == 0:
                            pos = jnp.einsum("mks,skl->ml", W0, HH[:, 0],
                                             preferred_element_type=dt)
                        else:
                            pos = Wprev @ HH[0, t]
                        dW = pos - VHt_all[:, :, t]
                        Wnew, st_new, under_t, obj_t = _line_search_obj(
                            obj_2d, W0[:, :, t], dW, step_w[t], proj_cols, begobj)
                        use = ~term
                        W = W.at[:, :, t].set(
                            jnp.where(use & ~under_t, Wnew, W[:, :, t]))
                        step_w = step_w.at[t].set(
                            jnp.where(use & ~under_t, st_new, step_w[t]))
                        term = term | (use & under_t)
                        begobj = obj_t       # next frame's begobj (cnmfsc.m:218)
                        Wprev = Wnew
                else:
                    V_hat = conv_reconstruct(W0, H, nv)  # cnmfsc.m:215
                    for t in range(T):
                        Hst = Hs[t]
                        neg = V @ Hst.T
                        pos = V_hat @ Hst.T
                        Wt = W0[:, :, t] * (neg / jnp.maximum(pos, eps))
                        W = W.at[:, :, t].set(jnp.where(term, W[:, :, t], Wt))
                        V_hat = jnp.maximum(
                            V_hat + (Wt - W0[:, :, t]) @ Hst, 0.0)  # cnmfsc.m:262

            # Commit the double buffer unless we terminated (cnmfsc.m:266).
            W0 = jnp.where(term, W0, W)
            c = conv_cost(W0, H)
            return (W0, W, H, step_w, step_h, c), c, term

        c0 = conv_cost(W_init, H0)  # initial cost uses W (cnmfsc.m:152)
        state0 = (W0_init, W_init, H0, st_w0, st_h0, c0)
        return looplib.run(step, state0, spec.maxiter, tolerance,
                           offset=1, initial_cost=c0, cost_dtype=dt)
    return solve


def cnmfsc(V, num_basis_elems: int, context_len: int,
           config: dict | None = None, **kwargs):
    """Convolutive NMF with sparseness constraints.  Returns (W, H, cost).

    Parameters (cnmfsc.m:9-45): W_init (m, k, T), H_init,
    W_sparsity/H_sparsity in [0, 1], W_fixed, H_fixed, maxiter (100),
    tolerance (1e-3).  V must be non-negative; it is rescaled by its max
    (cnmfsc.m:68-73).  cost[0] is the initial cost.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = ingest_rescaled(V, dtype)  # cnmfsc.m:68-73, device-resident
    m, n = V.shape
    k = int(num_basis_elems)
    T = int(context_len)

    maxiter, tolerance, eps, key = common_scalars(cfg)
    w_sp = min(float(cfg.get("W_sparsity", 0.0) or 0.0), 1.0)
    h_sp = min(float(cfg.get("H_sparsity", 0.0) or 0.0), 1.0)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = jax.random.uniform(kw, (m, k, T), dtype)  # cnmfsc.m:84-86
    W0 = jnp.asarray(W0, dtype)
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = jax.random.uniform(kh, (k, n), dtype)
        H0 = H0 / jnp.sqrt(jnp.sum(H0 * H0, axis=1, keepdims=True))  # cnmfsc.m:89-92
    H0 = jnp.asarray(H0, dtype)

    l1_w = hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0
    l1_h = hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0
    # Chunked continuation (utils/checkpoint.py): skip the initial
    # projections (factors are already feasible; re-projection is only
    # fp-approximately idempotent) and resume the per-frame stepsize
    # vector + scalar H stepsize (cnmfsc.m:147).  At a committed
    # iteration boundary W0 == W (cnmfsc.m:266), so W_init fills both
    # double-buffer slots exactly.
    # empty dict == no resume (a fresh run), checked consistently
    rs = cfg.get("resume_state") or None
    # Initial projections write W, NOT the W0 buffer (cnmfsc.m:94-124).
    W_proj = W0
    if rs is None:
        if w_sp > 0:
            W_proj = project_columns(W0.reshape(m, k * T), l1_w, 1.0)[0].reshape(m, k, T)
        if h_sp > 0:
            H0 = project_columns(H0.T, l1_h, 1.0)[0].T
    st_w0 = (np.asarray(rs["step_w"], dtype) if rs is not None
             else np.ones((T,), dtype))
    if st_w0.shape != (T,):
        raise ValueError(f"resume_state step_w has shape {st_w0.shape}, "
                         f"expected ({T},)")
    st_h0 = float(rs["step_h"]) if rs is not None else 1.0

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        W_proj = pad_axes(W_proj, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, W_proj, H0 = apply_placements(mesh, "cnmfsc",
                                         V=V, W=W0, W2=W_proj, H=H0)

    spec = _Spec(T, maxiter, w_sp > 0, h_sp > 0,
                 bool(cfg.get("W_fixed", False)), bool(cfg.get("H_fixed", False)),
                 eps, float(l1_w), float(l1_h), valid,
                 resolve_width(cfg.get("linesearch_width"), mesh))
    # 'highest' matmul precision for the line-search objectives (no-op on
    # CPU) — same TF32 cancellation hazard as nmfsc (models/nmfsc.py).
    with jax.default_matmul_precision("highest"):
        out = _build_solver(spec)(V, W0, W_proj, H0,
                                  jnp.asarray(tolerance, dtype),
                                  jnp.asarray(st_w0, dtype),
                                  jnp.asarray(st_h0, dtype))
    _, W, H = out.state[0], out.state[1], out.state[2]
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters),
                  converged=bool(out.stopped) or bool(out.terminated),
                  resume_state={"step_w": np.asarray(out.state[3]),
                                "step_h": float(out.state[4])})
