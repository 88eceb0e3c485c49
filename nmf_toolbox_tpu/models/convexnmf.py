"""Convex NMF (Ding, Li & Jordan 2010): V ~ (V G) H with G, H >= 0.

Accelerator re-design of convexnmf.m.  The n-by-n Gram V'V is computed
once and split into positive/negative parts (convexnmf.m:86-87); the MU
updates are re-associated so no extra n-by-n intermediate beyond the
Grams is materialized:

    (VV_neg @ G @ H) @ H'  ->  (VV_neg @ G) @ (H @ H')

(identical math, fewer FLOPs and far less HBM traffic at large n).  Two
further structural savings (see _build_solver): the symmetry of V'V lets
the H update and the cost share one Gram-times-factor product, and a
non-negative V (checked once per dispatch) makes VV_neg exactly zero,
specializing the step to 3 large products per iteration instead of 7.

Compat note (COMPAT.md): the reference's default G_init references
undefined variables (convexnmf.m:69-71) and errors unless the caller
supplies G_init.  The default here is the paper's init — G from the
kmeans indicator matrix, G = indicator * diag(1/cluster_sizes) — which is
what the shared ValidateParameters computes as 'W_init' for this
algorithm (ValidateParameters.m:105-109).
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
from ..ops.masking import col_mask
from ..ops.normalize import unit_sum_columns
from ..utils.init import kmeans_indicator_h
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    g_fixed: bool
    h_fixed: bool
    n_valid: int = None  # true n of a mesh-padded problem
    nonneg: bool = False  # V >= 0 everywhere -> VV_neg is exactly zero


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    # The one-time Grams arrive as ARGUMENTS of this executable, computed
    # eagerly at the entry point (same pattern as chcnmf.py).  Keeping
    # them as in-program intermediates looks equivalent but is not: XLA's
    # memory-pressure-driven rematerialization may recompute LARGE
    # loop-invariant buffers (the n-by-n Grams, 400 MB at n=10k) inside
    # the while_loop body every iteration rather than keeping them live —
    # and V'V is 2e13 FLOP at 100k x 10k.  Executable arguments cannot be
    # rematerialized.  Scalar invariants (v_sq) are not affected but
    # ride along as arguments.
    @jax.jit
    def solve(grams, G0, H0, v_sq, g_sparsity, tolerance):
        if spec.nonneg:
            (VtV,) = grams
        else:
            vv_pos, vv_neg = grams
        n = G0.shape[0]
        # Pad rows of G / pad columns of H have 0/0 sqrt-MU ratios (the
        # reference's updates are unguarded); pin them to zero.
        cmask = col_mask(n, spec.n_valid)

        def masked(ratio, colwise: bool):
            if cmask is None:
                return ratio
            sel = cmask[None, :] if colwise else cmask[:, None]
            return jnp.where(sel, ratio, jnp.zeros((), ratio.dtype))

        def cost(VtVG, G, H):
            # 0.5||V - V G H||^2 in Gram form (k-by-k only):
            # = 0.5(tr(V'V) - 2 tr(H' G' V'V) + tr((G' V'V G)(H H')))
            return jnp.maximum(  # clamp: see ops/gram.euclidean_cost_gram
                0.5 * (v_sq - 2.0 * jnp.sum(VtVG * H.T)
                       + jnp.sum((G.T @ VtVG) * (H @ H.T))), 0.0)

        # The n^2 k Gram-times-factor products dominate every iteration
        # (n-by-n times n-by-k / k-by-n); everything else is k-scale.
        # Two structural savings over the literal pos/neg formulation:
        #   * V'V is symmetric, so G'VV_pos = (VV_pos G)' — the H update
        #     and the cost share ONE product with the post-update G.
        #   * when V >= 0 (checked once at dispatch), VV_neg is exactly
        #     the zero matrix: its products vanish and VV_pos is V'V
        #     bit-for-bit, leaving 3 large products per iteration
        #     (VtV H', VtV G, VtV G_new) instead of 7.
        def step_nonneg(carry, i):
            G, H = carry
            if not spec.g_fixed:
                HHt = H @ H.T
                pG = VtV @ H.T
                nG = (VtV @ G) @ HHt
                G = G * jnp.sqrt(masked(pG / (nG + g_sparsity), False))  # convexnmf.m:94
                G = unit_sum_columns(G)                   # convexnmf.m:95
            VtVG = VtV @ G  # shared by the H update and the cost
            if not spec.h_fixed:
                GtVV = VtVG.T                             # symmetry of V'V
                H = H * jnp.sqrt(masked(GtVV / ((GtVV @ G) @ H), True))  # convexnmf.m:101
            return (G, H), cost(VtVG, G, H), jnp.asarray(False)

        def step_general(carry, i):
            G, H = carry
            if not spec.g_fixed:
                HHt = H @ H.T
                # ((VV_pos + VV_neg G H) H') -> VV_pos H' + (VV_neg G)(H H')
                pG = vv_pos @ H.T + (vv_neg @ G) @ HHt
                nG = vv_neg @ H.T + (vv_pos @ G) @ HHt
                G = G * jnp.sqrt(masked(pG / (nG + g_sparsity), False))  # convexnmf.m:94
                G = unit_sum_columns(G)                   # convexnmf.m:95
            PpG = vv_pos @ G  # shared (transposed) by H update + cost
            PnG = vv_neg @ G
            if not spec.h_fixed:
                # G'(VV_pos + VV_neg G H) -> (G'VV_pos) + (G'VV_neg G) H
                pH = PpG.T + (PnG.T @ G) @ H
                nH = PnG.T + (PpG.T @ G) @ H
                H = H * jnp.sqrt(masked(pH / nH, True))   # convexnmf.m:101
            return (G, H), cost(PpG - PnG, G, H), jnp.asarray(False)

        step = step_nonneg if spec.nonneg else step_general
        return looplib.run(step, (G0, H0), spec.maxiter, tolerance,
                           cost_dtype=G0.dtype)
    return solve


def convexnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Convex NMF; V may be mixed-sign.  Returns Result as (W, H, G, cost)
    with W = V @ G (convexnmf.m:84,97).

    Parameters: G_init (n, k), H_init (k, n), G_sparsity, G_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  Extras: dtype, seed.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, _, key = common_scalars(cfg)
    g_sparsity = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)

    compat = str(cfg.get("compat", "paper"))
    if compat not in ("paper", "reference"):
        raise ValueError(f"compat must be 'paper' or 'reference', got {compat!r}")
    H0 = cfg.get("H_init")
    G0 = cfg.get("G_init")
    if G0 is None and compat == "reference":
        # The reference's default G_init references undefined variables
        # (convexnmf.m:69-71) and always errors; reproduce that contract.
        raise ValueError(
            "compat='reference': convexnmf requires an explicit G_init "
            "(the reference's default at convexnmf.m:69-71 references "
            "undefined variables and errors)")
    if H0 is None or G0 is None:
        Hk = kmeans_indicator_h(key, V, k, dtype)  # indicator + 0.2
        if H0 is None:
            H0 = Hk
        if G0 is None:
            # Reference init (ValidateParameters.m:105-109):
            # G = H_init' * diag(1 ./ cluster_sizes) where the NUMERATOR is
            # the offset indicator H_init (strictly positive — exact zeros
            # would be frozen forever by the multiplicative update) and the
            # cluster sizes come from the un-offset indicator.
            ind = Hk - 0.2
            G0 = Hk.T / jnp.maximum(jnp.sum(ind, axis=1)[None, :], 1.0)
    G0 = unit_sum_columns(jnp.asarray(G0, dtype))  # convexnmf.m:83
    H0 = jnp.asarray(H0, dtype)

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        G0 = pad_axes(G0, {0: pad_n})  # G is (n, k): rows follow samples
        H0 = pad_axes(H0, {1: pad_n})
    V, G0, H0 = apply_placements(mesh, "convexnmf", V=V, G=G0, H=H0)

    # One scalar readback per dispatch: V >= 0 selects the specialized
    # step with exactly-zero VV_neg (3 large products/iter instead of 7).
    nonneg = bool(jnp.all(V >= 0))
    spec = _Spec(maxiter, bool(cfg.get("G_fixed", False)),
                 bool(cfg.get("H_fixed", False)),
                 None if valid is None else n, nonneg)
    # One-time Gram, eagerly OUTSIDE the solver executable (see
    # _build_solver's rematerialization note).  Padded V has zero pads,
    # so the padded Gram rows/cols are zero — identical to the previous
    # in-program computation.
    VtV = V.T @ V  # convexnmf.m:86-87
    v_sq = jnp.trace(VtV)
    grams = (VtV,) if nonneg else pos_neg_split(VtV)
    out = _build_solver(spec)(grams, G0, H0, v_sq,
                              jnp.asarray(g_sparsity, dtype),
                              jnp.asarray(tolerance, dtype))
    G, H = out.state
    if valid is not None:
        G, H = G[:n], H[:, :n]
        V = V[:m, :n]
    W = np.asarray(V @ G)
    return Result(fields=("W", "H", "G", "cost"),
                  W=W, H=np.asarray(H), G=np.asarray(G),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
