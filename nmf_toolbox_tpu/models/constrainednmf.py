"""Semi-supervised NMF with hard label constraints (Liu & Wu 2010).

Accelerator re-design of constrainednmf.m: V ~ W Z A where A is the fixed
label-structure block matrix [I 0; 0 C] (unlabeled samples first,
constrainednmf.m:160-172) and H = Z A.

The W update is the same four-divergence MU family as nmf (shared
divergence-field library); the Z update projects the gradient fields
through A' (constrainednmf.m:214-235).  A is a fixed 0/1 selection
matrix: Phi @ A' is a concatenation of [unlabeled columns of Phi |
per-class column sums], implemented as slice + segment matmul rather
than an (n, n_u + C) dense product.

Compat note (COMPAT.md): the reference's AB-divergence Z update
(constrainednmf.m:229) is shape-inconsistent as written (MATLAB's
left-to-right * /.* precedence makes W'*V.^a .* V_hat.^(b-1) a (k, n)
.* (m, n) product); the paper-correct grouping
W'(V.^a .* V_hat.^(b-1))A' is used here.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, merge_config, parse_cost_every,
                    resolve_dtype, uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns
from ..parallel import (apply_placements, pad_axes, plan_padding,
                        prepare_weights)


class _Spec(NamedTuple):
    divergence: str
    alpha: float
    beta: float
    maxiter: int
    w_fixed: bool
    z_fixed: bool
    n_unlabeled: int
    num_classes: int
    eps: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    cost_every: int = 1  # objective cadence (1 = reference semantics)


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    div, alpha, beta = spec.divergence, spec.alpha, spec.beta
    n_u, C = spec.n_unlabeled, spec.num_classes

    @jax.jit
    def solve(V, W0, Z0, class_onehot, wsp, zsp, tolerance, Mw=None):
        # class_onehot: (C, n_labeled) 0/1 matrix (the C block of A).
        dt = V.dtype
        eps = jnp.asarray(spec.eps, dt)
        m, n = V.shape
        mask = region_mask(V.shape, spec.valid)

        def apply_A(Z):
            """H = Z A: unlabeled block passes through, labeled block is
            the class columns of Z gathered per sample."""
            return jnp.concatenate([Z[:, :n_u], Z[:, n_u:] @ class_onehot], axis=1)

        def apply_At(X):
            """X @ A': keep unlabeled columns; per-class sums of labeled."""
            return jnp.concatenate(
                [X[:, :n_u], X[:, n_u:] @ class_onehot.T], axis=1)

        ce = int(spec.cost_every)
        cadence = looplib.cost_cadence(ce, spec.maxiter)

        def step(carry, i):
            W, Z = carry[0], carry[1]
            H = apply_A(Z)
            V_hat = W @ H
            if not spec.w_fixed:
                phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha,
                                                    beta, mask=mask,
                                                    weights=Mw)
                A_ = phi_neg @ H.T
                if phi_pos is None:
                    B_ = jnp.broadcast_to(jnp.sum(H, axis=1)[None, :], A_.shape)
                else:
                    B_ = phi_pos @ H.T
                dneg = jnp.sum(W * B_, axis=0)
                dpos = jnp.sum(W * A_, axis=0)
                neg = dv.apply_power(A_ + W * dneg[None, :], power)
                pos = dv.apply_power(B_ + W * dpos[None, :], power)
                W = W * (neg / jnp.maximum(pos + wsp, eps))
                W = unit_l2_columns(W)
                V_hat = W @ H
            if not spec.z_fixed:
                phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha,
                                                    beta, mask=mask,
                                                    weights=Mw)
                neg = apply_At(W.T @ phi_neg)
                if phi_pos is None:
                    pos = apply_At(jnp.broadcast_to(
                        jnp.sum(W, axis=0)[:, None], (W.shape[1], n)))
                else:
                    pos = apply_At(W.T @ phi_pos)
                neg = dv.apply_power(neg, power)
                pos = dv.apply_power(pos, power)
                Z = Z * (neg / jnp.maximum(pos + zsp, eps))
                H = apply_A(Z)
                V_hat = W @ H
            def cost_fn(W=W, Z=Z, V_hat=V_hat):
                # The objective's divergence-field pass over the m x n
                # reconstruction exists only for the stop rule;
                # cost_every > 1 skips it (the updates' own dv.fields
                # passes are untouched).
                c = dv.cost(div, V, V_hat, alpha, beta, mask=mask,
                            weights=Mw)
                return (c + wsp * jnp.sum(jnp.abs(W))
                        + zsp * jnp.sum(jnp.abs(Z)))

            return cadence((W, Z), carry, i, cost_fn)

        return looplib.run(step, looplib.cadence_state((W0, Z0), ce, dt),
                           spec.maxiter, tolerance,
                           cost_dtype=dt, cost_every=ce)
    return solve


def constrainednmf(V, labels, num_basis_elems: int,
                   config: dict | None = None, **kwargs):
    """Constrained NMF.  Returns Result as (W, H, Z, A, cost).

    Parameters (constrainednmf.m:100-142): divergence/alpha/beta (as nmf),
    W_init, Z_init, W_sparsity, Z_sparsity, W_fixed, Z_fixed,
    maxiter (100), tolerance (1e-3).  ``labels`` is length-n; -1 marks
    unlabeled samples.  A and H are returned in the ORIGINAL sample order
    (constrainednmf.m:260-267).  Extras: cost_every (objective cadence —
    skips the objective's divergence-field pass on non-check iterations).
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)
    labels = np.asarray(labels)
    if len(labels) != n:
        raise ValueError(
            f"Length of the label vector not equal to number of samples. "
            f"Length of label vector = {len(labels)}; number of samples = {n}")

    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div == "ab":
        alpha = float(cfg.get("alpha", 1.0))
        beta = float(cfg.get("beta", 1.0))
        if alpha == 0.0 and beta == 0.0:
            raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    else:
        alpha, beta = 1.0, 1.0

    maxiter, tolerance, eps, key = common_scalars(cfg)
    wsp = max(float(cfg.get("W_sparsity", 0.0) or 0.0), 0.0)
    zsp = max(float(cfg.get("Z_sparsity", 0.0) or 0.0), 0.0)
    kw, kz = jax.random.split(key)

    # Label preprocessing (constrainednmf.m:147-172).
    num_labeled = int(np.sum(labels > -1))
    uniq = np.unique(labels)
    if num_labeled < n:
        num_classes = len(uniq) - 1
        lp = np.searchsorted(uniq, labels)
        lp = np.where(lp == 0, -1, lp)
    else:
        num_classes = len(uniq)
        lp = np.searchsorted(uniq, labels) + 1
    sorted_idx = np.argsort(lp, kind="stable")
    sorted_labels = lp[sorted_idx]
    n_u = n - num_labeled
    V_sorted = V[:, jnp.asarray(sorted_idx)]
    class_onehot = np.zeros((num_classes, num_labeled), dtype)
    for s in range(n_u, n):
        class_onehot[sorted_labels[s] - 1, s - n_u] = 1.0

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(kw, (m, k), dtype, floor_eps=False)  # constrainednmf.m:101
    W0 = unit_l2_columns(jnp.asarray(W0, dtype))  # constrainednmf.m:144-145
    Z0 = cfg.get("Z_init")
    if Z0 is None:
        Z0 = uniform_init(kz, (k, n_u + num_classes), dtype, floor_eps=False)  # :174
    Z0 = jnp.asarray(Z0, dtype)

    weights = cfg.get("weights")
    if weights is not None:
        # per-entry weights follow V through the unlabeled-first reorder
        weights = jnp.asarray(weights, dtype)
        if weights.shape == (m, n):
            weights = weights[:, jnp.asarray(sorted_idx)]

    # Mesh padding: Z is replicated (small), so only V pads; the labeled
    # block of A gains zero columns so H = Z A matches the padded n.
    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    onehot_in = jnp.asarray(class_onehot)
    if valid is not None:
        V_sorted = pad_axes(V_sorted, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        onehot_in = pad_axes(onehot_in, {1: pad_n})
    V_sorted, W0, Z0 = apply_placements(mesh, "constrainednmf",
                                        V=V_sorted, W=W0, Z=Z0)
    weights = prepare_weights(weights, dtype, (m, n), mesh,
                              "constrainednmf", pad_m, pad_n, valid)

    spec = _Spec(div, alpha, beta, maxiter, bool(cfg.get("W_fixed", False)),
                 bool(cfg.get("Z_fixed", False)), n_u, num_classes, eps, valid,
                 parse_cost_every(cfg))
    solve = _build_solver(spec)
    solve_args = (V_sorted, W0, Z0, onehot_in,
                  jnp.asarray(wsp, dtype), jnp.asarray(zsp, dtype),
                  jnp.asarray(tolerance, dtype))
    out = solve(*solve_args) if weights is None else \
        solve(*solve_args, weights)
    W, Z = out.state[0], out.state[1]
    if valid is not None:
        W = W[:m]

    # Materialize A in the original sample order (constrainednmf.m:263-267).
    A_sorted = np.zeros((n_u + num_classes, n))
    A_sorted[:n_u, :n_u] = np.eye(n_u)
    A_sorted[n_u:, n_u:] = np.asarray(class_onehot)
    A = np.zeros_like(A_sorted)
    A[:, sorted_idx] = A_sorted
    Znp = np.asarray(Z)
    return Result(fields=("W", "H", "Z", "A", "cost"),
                  W=np.asarray(W), H=Znp @ A, Z=Znp, A=A,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
