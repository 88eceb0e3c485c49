"""Convex-hull NMF (Thurau et al. 2011): V ~ S G H, S = hull anchors of V.

Accelerator re-design of chnmf.m.  The expensive one-time init (covariance
eigenvectors + per-pair 2-D convex hulls, chnmf.m:85-106) lives in
utils/init.convex_hull_anchors — eigvecs via on-device eigh or randomized
subspace iteration (the m-by-m covariance is never materialized for large
m), hulls via a host monotone chain.  The loop itself touches only p-by-n
and k-by-n quantities; the cost uses the Gram identity so the m-by-n
reconstruction of chnmf.m:191 is never formed.

Compat note (COMPAT.md): the reference's H update (chnmf.m:187) omits the
G' projection and is shape-inconsistent unless p == k.  The paper-correct
update (the analog of convexnmf.m:101, without sqrt to stay close to the
reference's form) is used here:

    H <- H .* (G'(S_V_pos + S_S_neg G H)) ./ max(G'(S_V_neg + S_S_pos G H) + H_sparsity, eps)
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
from ..utils.init import convex_hull_anchors
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    g_fixed: bool
    h_fixed: bool
    eps: float
    compat: bool = False  # reference-exact buggy H update (chnmf.m:187)


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    # The one-time Grams arrive as ARGUMENTS, computed eagerly at the
    # entry (chcnmf.py pattern): XLA's memory-pressure-driven
    # rematerialization may recompute large loop-invariant buffers
    # inside the while_loop body every iteration, so an in-program S'V
    # (p*m*n FLOP, a p-by-n buffer produced from the 4 GB V) could be
    # paid every iteration.  As executable arguments they cannot be
    # rematerialized; the solver never touches the m-sized axis at all.
    @jax.jit
    def solve(StV, StS, G0, H0, v_sq, g_sparsity, h_sparsity, tolerance):
        eps = jnp.asarray(spec.eps, StV.dtype)
        sv_pos, sv_neg = pos_neg_split(StV)
        ss_pos, ss_neg = pos_neg_split(StS)

        def step(carry, i):
            G, H = carry
            if not spec.g_fixed:
                HHt = H @ H.T
                # ((S_V_pos + S_S_neg G H) H') -> S_V_pos H' + (S_S_neg G)(H H')
                nG = sv_pos @ H.T + (ss_neg @ G) @ HHt
                pG = sv_neg @ H.T + (ss_pos @ G) @ HHt
                G = G * (nG / jnp.maximum(pG + g_sparsity, eps))  # chnmf.m:180
                G = unit_sum_columns(G)                           # chnmf.m:181
            if not spec.h_fixed:
                if spec.compat:
                    # compat="reference": the literal chnmf.m:187 update,
                    # which omits the G' projection and is only
                    # shape-consistent when p == k (checked at entry).
                    nH = sv_pos + (ss_neg @ G) @ H
                    pH = sv_neg + (ss_pos @ G) @ H
                else:
                    GtSV_pos = G.T @ sv_pos
                    GtSV_neg = G.T @ sv_neg
                    nH = GtSV_pos + (G.T @ ss_neg @ G) @ H
                    pH = GtSV_neg + (G.T @ ss_pos @ G) @ H
                H = H * (nH / jnp.maximum(pH + h_sparsity, eps))
            # cost 0.5||V - S G H||^2 via Grams (W = S G, chnmf.m:183,190-192)
            StVG = StV.T @ G           # (n, k) — V'(S G)
            GtStSG = G.T @ (StS @ G)   # (k, k)
            c = jnp.maximum(  # clamp: see ops/gram.euclidean_cost_gram
                0.5 * (v_sq - 2.0 * jnp.sum(StVG * H.T)
                       + jnp.sum(GtStSG * (H @ H.T))), 0.0)
            return (G, H), c, jnp.asarray(False)

        return looplib.run(step, (G0, H0), spec.maxiter, tolerance,
                           cost_dtype=StV.dtype)
    return solve


def chnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Convex-hull NMF.  Returns Result as (W, H, S, G, cost), W = S @ G.

    Parameters (chnmf.m:71-167): S_init (hull anchors; default extracted
    from V), pct_eigval_energy (0.95), G_init, H_init, G_sparsity,
    H_sparsity, G_fixed, H_fixed, maxiter (100), tolerance (1e-3).
    Extras: dtype, seed, max_eigvecs (cap on principal directions
    examined, default 16), compat ("paper" default / "reference":
    reproduce the literal chnmf.m:187 H update, which omits the G'
    projection and requires hull size p == k).
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)

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

    G0 = cfg.get("G_init")
    if G0 is None:
        G0 = jax.random.uniform(kg, (p, k), dtype)  # chnmf.m:111-113
    G0 = unit_sum_columns(jnp.asarray(G0, dtype))   # chnmf.m:115
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = jax.random.uniform(kh, (k, n), dtype)  # chnmf.m:135
    H0 = jnp.asarray(H0, dtype)

    g_sp = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)
    h_sp = max(float(cfg.get("H_sparsity", 0.0) or 0.0), 0.0)

    compat = str(cfg.get("compat", "paper"))
    if compat not in ("paper", "reference"):
        raise ValueError(f"compat must be 'paper' or 'reference', got {compat!r}")
    if compat == "reference" and p != k:
        # The literal chnmf.m:187 update is shape-inconsistent unless the
        # hull size equals the rank (MATLAB errors at runtime there too).
        raise ValueError(
            f"compat='reference' requires hull size p == k (got p={p}, "
            f"k={k}); the reference's H update (chnmf.m:187) omits the G' "
            "projection and only runs for p == k")

    # Mesh padding (parallel/padding.py): the hull is extracted from the
    # TRUE V above; zero pads are exact here because every update is
    # eps-guarded (pad columns of H have zero numerators and stay zero)
    # and the cost is Gram-form.
    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        S = pad_axes(S, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, S, G0, H0 = apply_placements(mesh, "chnmf", V=V, S=S, G=G0, H=H0)

    spec = _Spec(maxiter, bool(cfg.get("G_fixed", False)),
                 bool(cfg.get("H_fixed", False)), eps,
                 compat == "reference")
    # One-time Grams (chnmf.m:169-172), eagerly OUTSIDE the solver
    # executable (see _build_solver's rematerialization note).  Zero pads
    # on the m axis contribute exactly zero to both Grams.
    StV = S.T @ V
    StS = S.T @ S
    v_sq = jnp.sum(V * V)
    out = _build_solver(spec)(StV, StS, G0, H0, v_sq,
                              jnp.asarray(g_sp, dtype), jnp.asarray(h_sp, dtype),
                              jnp.asarray(tolerance, dtype))
    G, H = out.state
    if valid is not None:
        S, H = S[:m], H[:, :n]
    return Result(fields=("W", "H", "S", "G", "cost"),
                  W=np.asarray(S @ G), H=np.asarray(H),
                  S=np.asarray(S), G=np.asarray(G),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
