"""Gram-matrix utilities: pos/neg splits and Gram-form Euclidean costs.

The semi-NMF / convex family splits Gram matrices into positive and
negative parts (convexnmf.m:86-87, seminmf.m:73-76, chnmf.m:169-172):

    A_pos = (|A| + A) / 2,   A_neg = (|A| - A) / 2.

The Euclidean cost identities below are the device-first core of this
framework: 0.5*||V - W H||_F^2 is evaluated from k-by-k Grams without
ever materializing the m-by-n reconstruction, turning the reference's
~6 full-size matmuls per iteration into 2 (SURVEY.md section 2.4).
"""
from __future__ import annotations

import jax.numpy as jnp


def pos_neg_split(A):
    """Return (A_pos, A_neg) with A = A_pos - A_neg, both non-negative."""
    absA = jnp.abs(A)
    return 0.5 * (absA + A), 0.5 * (absA - A)


def sq_norm(V):
    """||V||_F^2 (precomputed once; constant across iterations)."""
    return jnp.sum(V * V)


def euclidean_cost_gram(v_sq, WtV, WtW, H):
    """0.5*||V - W H||^2 = 0.5*(||V||^2 - 2<W'V, H> + <W'W H, H>).

    All operands are k-by-n / k-by-k; no m-by-n intermediate.  Clamped at
    zero: the identity cancels catastrophically once the true residual
    nears the dtype's precision floor, while the reference's residual form
    (0.5*sum((V - V_hat).^2), nmf.m:208) is nonnegative by construction.
    """
    c = 0.5 * (v_sq - 2.0 * jnp.sum(WtV * H) + jnp.sum((WtW @ H) * H))
    return jnp.maximum(c, 0.0)


def euclidean_cost_gram_w(v_sq, VHt, HHt, W):
    """Same identity arranged for a W line search (H fixed):
    0.5*(||V||^2 - 2<V H', W> + <W'W, H H'>)."""
    WtW = W.T @ W
    c = 0.5 * (v_sq - 2.0 * jnp.sum(VHt * W) + jnp.sum(WtW * HHt))
    return jnp.maximum(c, 0.0)


def conv_cross_grams_w(W):
    """WW[t, s] = W[:, :, t]' @ W[:, :, s]  -> (T, T, k, k).

    Cross-frame Grams of a convolutive basis; with the shifted-H Grams
    below they evaluate ||sum_t W_t H^(t)||_F^2 without materializing the
    reconstruction (used by cnmf/cnmfsc/chcnmf Gram paths)."""
    return jnp.einsum("mkt,mls->tskl", W, W, preferred_element_type=W.dtype)


def conv_cross_grams_h(Hs):
    """HH[t, s] = Hs[t] @ Hs[s]'  -> (T, T, k, k) for stacked shifted H."""
    return jnp.einsum("tkn,sln->tskl", Hs, Hs, preferred_element_type=Hs.dtype)
