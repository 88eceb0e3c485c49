"""Convex-hull convolutive NMF (Vaz 2016): V ~ sum_t S G[:, :, t] H^(t).

Accelerator re-design of chcnmf.m (the live code path; the reference's
~150 lines of commented-out Hoyer/given-W branches are dead code and not
ported — chcnmf.m:244-296,323-366,384-424).

The reference keeps an encoding-space reconstruction F = sum_t G_t H^(t)
(p-by-n) and updates it incrementally with a clamp after each frame's
multiplicative step (chcnmf.m:315,363-368).  Because of that clamp the
frame loop is inherently sequential; it stays a (static, unrolled) loop
over T.  Everything else is restructured for dense matmuls:

* the H-gradient accumulation over shifted sparse identities
  (chcnmf.m:374-383) uses shift_left(G_t'(S_V_pos + S_S_neg F), t) — no
  n-by-n identity matrices, one batched matmul over T;
* the cost never touches the m-by-n data: 0.5||V - sum_t S G_t H^(t)||^2
  is evaluated from S'V / S'S Grams and shifted-H cross-Grams, so the
  whole loop runs in (p, n)/(k, n) space.

Given W_init, G_init is fitted by the reference's inner MU loop
(W_t ~ S G_t, 100 iterations, tol 1e-5 — chcnmf.m:140-170), run on
device via lax.while_loop; W_fixed implies G_fixed (chcnmf.m:133-137).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import common_scalars, Result, merge_config, resolve_dtype
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.normalize import unit_sum_columns
from ..ops.shift import shift_left, stack_shifts_right
from ..utils.init import convex_hull_anchors
from ..ops.gram import conv_cross_grams_h as _cross_grams_h
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    context_len: int
    maxiter: int
    g_fixed: bool
    h_fixed: bool
    eps: float
    n_valid: int = None  # true n of a mesh-padded problem


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    T = spec.context_len

    @jax.jit
    def solve(V_sq, StV, StS, G0_in, H0, g_sparsity, h_sparsity, tolerance):
        dt = StV.dtype
        eps = jnp.asarray(spec.eps, dt)
        sv_pos, sv_neg = pos_neg_split(StV)
        ss_pos, ss_neg = pos_neg_split(StS)
        nv = spec.n_valid  # truncate shift spill past the true n (padding)

        def conv_f(G, H):
            Hs = stack_shifts_right(H, T, nv)
            return jnp.einsum("pkt,tkn->pn", G, Hs, preferred_element_type=dt)

        def cost_fn(G, H):
            # 0.5||V - sum_t S G_t H^(t)||^2 via Grams only.
            Hs = stack_shifts_right(H, T, nv)
            lin = jnp.einsum("pn,tkn,pkt->", StV, Hs, G)
            StSG = jnp.einsum("pq,qls->pls", StS, G, preferred_element_type=dt)
            E = jnp.einsum("pkt,pls->tskl", G, StSG, preferred_element_type=dt)
            sq = jnp.sum(E * _cross_grams_h(Hs))
            return (jnp.maximum(0.5 * (V_sq - 2.0 * lin + sq), 0.0)
                    + h_sparsity * jnp.sum(H))

        def step(carry, i):
            G0, H, _ = carry
            G = G0
            F = conv_f(G0, H)
            if not spec.g_fixed:
                Hs_m = stack_shifts_right(H, T, nv)
                for t in range(T):  # sequential: F is clamped incrementally
                    Hst = Hs_m[t]
                    num = (sv_pos + ss_neg @ F) @ Hst.T
                    den = (sv_neg + ss_pos @ F) @ Hst.T
                    Gt = G0[:, :, t] * (num / jnp.maximum(den + g_sparsity, eps))
                    Gt = unit_sum_columns(Gt)
                    G = G.at[:, :, t].set(Gt)
                    F = jnp.maximum(F + (Gt - G0[:, :, t]) @ Hst, 0.0)  # chcnmf.m:367
            if not spec.h_fixed:
                F = conv_f(G, H)  # chcnmf.m:375
                P1 = sv_pos + ss_neg @ F
                P2 = sv_neg + ss_pos @ F
                B1 = jnp.einsum("pkt,pn->tkn", G, P1, preferred_element_type=dt)
                B2 = jnp.einsum("pkt,pn->tkn", G, P2, preferred_element_type=dt)
                neg = B1[0]
                pos = B2[0]
                for t in range(1, T):
                    neg = neg + shift_left(B1[t], t)
                    pos = pos + shift_left(B2[t], t)
                H = H * (neg / jnp.maximum(pos + h_sparsity, eps))
            c = cost_fn(G, H)
            # G0 commit happens AFTER the convergence check in the
            # reference (chcnmf.m:431-437); the committed value only feeds
            # the next iteration, so committing here is equivalent.
            return (G, H, c), c, jnp.asarray(False)

        c0 = cost_fn(G0_in, H0)
        return looplib.run(step, (G0_in, H0, c0), spec.maxiter, tolerance,
                           offset=1, initial_cost=c0, cost_dtype=dt)
    return solve


def _fit_g_to_w(S, W_init, G0, tol=1e-5, iters=100):
    """Inner MU fit G_t s.t. W_t ~ S G_t (chcnmf.m:140-170)."""
    StS = S.T @ S
    ss_pos, ss_neg = pos_neg_split(StS)
    T = W_init.shape[2]
    outs = []
    for t in range(T):
        Wt = W_init[:, :, t]
        StW = S.T @ Wt
        sw_pos, sw_neg = pos_neg_split(StW)
        Gt = unit_sum_columns(G0[:, :, t])

        def cond(carry):
            _, prev, it, done = carry
            return (~done) & (it < iters)

        def body(carry):
            G, prev, it, _ = carry
            G = G * ((sw_pos + ss_neg @ G) / (sw_neg + ss_pos @ G))
            G = unit_sum_columns(G)
            r = Wt - S @ G
            cur = 0.5 * jnp.sum(r * r)
            done = (cur <= prev) & (prev - cur <= tol)
            return G, cur, it + 1, done

        Gt, _, _, _ = jax.lax.while_loop(
            cond, body, (Gt, jnp.asarray(jnp.inf, Wt.dtype), jnp.int32(0),
                         jnp.asarray(False)))
        outs.append(Gt)
    return jnp.stack(outs, axis=2)


def chcnmf(V, num_basis_elems: int, context_len: int,
           config: dict | None = None, **kwargs):
    """Convex-hull convolutive NMF.  Returns (W, H, S, G, cost) with
    W[:, :, t] = S @ G[:, :, t].

    Parameters (chcnmf.m:9-82): S_init (default: hull anchors of V, with
    the n<=2 special case at chcnmf.m:101-102), pct_eigval_energy (0.95),
    W_init (fits G_init via inner MU), G_init, H_init, G_sparsity,
    H_sparsity, W_fixed (implies G_fixed), G_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  cost[0] is the initial cost.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)
    T = int(context_len)

    maxiter, tolerance, eps, _ = common_scalars(cfg)
    pct = float(cfg.get("pct_eigval_energy", 0.95))
    if not (0.0 <= pct <= 1.0):
        pct = 0.95
    seed = int(cfg.get("seed", 0))
    key = jax.random.PRNGKey(seed)
    kg, kh = jax.random.split(key)

    S = cfg.get("S_init")
    if S is None:
        S = convex_hull_anchors(V, pct, int(cfg.get("max_eigvecs", 16)), seed)
    S = jnp.asarray(S, dtype)
    p = S.shape[1]

    g_fixed = bool(cfg.get("G_fixed", False))
    if bool(cfg.get("W_fixed", False)):
        g_fixed = True  # chcnmf.m:133-137

    W_init = cfg.get("W_init")
    G0 = cfg.get("G_init")
    if W_init is not None:
        G_rand = jax.random.uniform(kg, (p, k, T), dtype)
        G0 = _fit_g_to_w(S, jnp.asarray(W_init, dtype), G_rand)
    elif G0 is None:
        G0 = jax.random.uniform(kg, (p, k, T), dtype)
    G0 = jnp.asarray(G0, dtype)
    G0 = G0 / jnp.sum(G0, axis=0, keepdims=True)  # per-frame col-sum 1

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = jax.random.uniform(kh, (k, n), dtype)
    H0 = jnp.asarray(H0, dtype)

    g_sp = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)
    h_sp = max(float(cfg.get("H_sparsity", 0.0) or 0.0), 0.0)

    StV = S.T @ V
    StS = S.T @ S
    v_sq = jnp.sum(V * V)

    # Mesh padding: the hull/Grams above are computed from the TRUE V;
    # only the sample axis of StV/H pads (the p axis is replicated).
    mesh = cfg.get("mesh")
    _, pad_n, valid = plan_padding(mesh, StV.shape[0], n)
    if valid is not None and pad_n:
        StV = pad_axes(StV, {1: pad_n})
        H0 = pad_axes(H0, {1: pad_n})
    StV, G0, H0 = apply_placements(mesh, "chcnmf", V=StV, G=G0, H=H0)

    spec = _Spec(T, maxiter, g_fixed, bool(cfg.get("H_fixed", False)), eps,
                 n if pad_n else None)
    out = _build_solver(spec)(v_sq, StV, StS, G0, H0,
                              jnp.asarray(g_sp, dtype), jnp.asarray(h_sp, dtype),
                              jnp.asarray(tolerance, dtype))
    G, H, _ = out.state
    if pad_n:
        H = H[:, :n]
    W = jnp.einsum("mp,pkt->mkt", S, G)
    return Result(fields=("W", "H", "S", "G", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  S=np.asarray(S), G=np.asarray(G),
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
