"""Time-shift operators for the convolutive family.

Two distinct shifts appear in the reference (SURVEY.md section 2.3 item 6):

  * H shifted RIGHT by t:   [zeros(k, t), H(:, 1:n-t)]      (cnmf.m:181)
  * V/targets shifted LEFT: [V(:, t+1:n), zeros(m, t)]      (cnmf.m:219)

(t here is 0-based; MATLAB writes t-1.)  Both are static pads/slices, so
XLA fuses them into the surrounding matmuls; under a column-sharded mesh
pjit lowers them to collective-permutes of the (context_len - 1)-column
halo automatically.
"""
from __future__ import annotations

import jax.numpy as jnp


def shift_right(X, t: int):
    """[zeros(:, t), X(:, :n-t)] along the last axis."""
    if t == 0:
        return X
    n = X.shape[-1]
    pad = [(0, 0)] * (X.ndim - 1) + [(t, 0)]
    return jnp.pad(X, pad)[..., :n]


def shift_left(X, t: int):
    """[X(:, t:), zeros(:, t)] along the last axis."""
    if t == 0:
        return X
    pad = [(0, 0)] * (X.ndim - 1) + [(0, t)]
    return jnp.pad(X, pad)[..., t:]


def stack_shifts_right(H, T: int, n_valid: int | None = None):
    """(T, k, n) tensor of right-shifted copies of H; cheap for T <= ~16.

    ``n_valid`` masks the shift SPILL of a mesh-padded problem: the true
    signal ends at column n_valid, so a right shift must truncate there —
    columns >= n_valid of every shifted copy are zeroed (otherwise valid
    H data spills into the pad region and changes the cross-Grams and the
    reconstruction vs the unpadded problem; parallel/padding.py).
    """
    Hs = jnp.stack([shift_right(H, t) for t in range(T)], axis=0)
    if n_valid is not None and n_valid < H.shape[-1]:
        cols = jnp.arange(H.shape[-1]) < n_valid
        Hs = jnp.where(cols[None, None, :], Hs, jnp.zeros((), Hs.dtype))
    return Hs


def conv_reconstruct(W, H, n_valid: int | None = None):
    """Convolutive reconstruction V_hat = sum_t W[:, :, t] @ shift_right(H, t).

    Reference: ReconstructFromDecomposition.m:32-38.  W is (m, k, T).
    Implemented as ONE batched matmul over the stacked shifts so the
    matmul units see a single (T, m, n) contraction instead of T small
    matmuls.
    ``n_valid``: see :func:`stack_shifts_right`.
    """
    T = W.shape[2]
    Hs = stack_shifts_right(H, T, n_valid)  # (T, k, n)
    return jnp.einsum("mkt,tkn->mn", W, Hs, preferred_element_type=W.dtype)


def reconstruct(W, H):
    """V_hat from a 2-D basis (W @ H) or a 3-D convolutive basis.

    Reference: ReconstructFromDecomposition.m:30-38.  Accepts a list of
    per-source factors (cell-array semantics, RFD.m:23-28).
    """
    if isinstance(W, (list, tuple)):
        W = jnp.concatenate([jnp.asarray(w) for w in W], axis=1)
    if isinstance(H, (list, tuple)):
        H = jnp.concatenate([jnp.asarray(h) for h in H], axis=0)
    if W.ndim == 2:
        return W @ H
    if H.ndim == 3:  # nmf2d factors: H carries a pitch axis (k, n, P)
        return conv_reconstruct_2d(W, H)
    return conv_reconstruct(W, H)


def conv_wt_phi(W, Phi):
    """sum_t W[:, :, t]' @ shift_left(Phi, t)  -> (k, n).

    The H-update gradient accumulation of cnmf.m:216-227.  Uses the identity
    W_t' @ shift_left(Phi, t) == shift_left(W_t' @ Phi, t) to avoid ever
    stacking T copies of the m-by-n field: one batched (T) matmul producing
    (T, k, n), then cheap shifts of the small k-by-n slabs.
    """
    T = W.shape[2]
    B = jnp.einsum("mkt,mn->tkn", W, Phi, preferred_element_type=W.dtype)
    out = B[0]
    for t in range(1, T):
        out = out + shift_left(B[t], t)
    return out


def conv_phi_ht(Phi, H, T: int, n_valid: int | None = None):
    """Phi @ shift_right(H, t)' for all t -> (m, k, T).

    The W-update gradient of cnmf.m:182-192, batched into one matmul over
    the stacked H shifts.  ``n_valid``: see :func:`stack_shifts_right`
    (exactness holds whenever Phi's pad columns are zero, but masking here
    keeps the contraction independent of pad garbage).
    """
    Hs = stack_shifts_right(H, T, n_valid)  # (T, k, n)
    return jnp.einsum("mn,tkn->mkt", Phi, Hs, preferred_element_type=Phi.dtype)


def shift_down_rows(X, p: int):
    """[zeros(p, :); X(1:m-p, :)] along axis -2 (the 2-D deconvolution
    family's pitch shift on a log-frequency axis; models/nmf2d.py)."""
    if p == 0:
        return X
    m = X.shape[-2]
    pad = [(0, 0)] * (X.ndim - 2) + [(p, 0), (0, 0)]
    return jnp.pad(X, pad)[..., :m, :]


def shift_up_rows(X, p: int):
    """[X(p+1:, :); zeros(p, :)] along axis -2 — the adjoint of
    :func:`shift_down_rows` (shift_down(W, p)' @ X == W' @ shift_up(X, p))."""
    if p == 0:
        return X
    pad = [(0, 0)] * (X.ndim - 2) + [(0, p), (0, 0)]
    return jnp.pad(X, pad)[..., p:, :]


def conv_reconstruct_2d(W, H, n_valid: int | None = None):
    """2-D deconvolutional reconstruction (models/nmf2d.py):
    sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t).

    Uses the commutation of the row shift with the column-space matmul:
    = sum_p shift_down(conv_reconstruct(W, H[:, :, p]), p).
    W (m, k, T), H (k, n, P) -> (m, n).  ``n_valid``: see
    :func:`stack_shifts_right` (mesh-padded problems).
    """
    P = H.shape[2]
    parts = [shift_down_rows(conv_reconstruct(W, H[:, :, p], n_valid), p)
             for p in range(P)]
    return sum(parts[1:], parts[0])
