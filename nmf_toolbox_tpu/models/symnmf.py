"""Symmetric NMF: A ~ H H' (Ding, He & Simon 2005).

Beyond-reference solver for clustering: A is a symmetric nonnegative
similarity/affinity matrix (a kernel, a graph adjacency — or the
consensus matrix from ``nt.consensus_stability``, whose (i, j) entry is
the fraction of NMF restarts clustering samples i and j together), and
the factor H (n, k) >= 0 is a soft cluster-indicator whose row-wise
argmax is the hard assignment.  SymNMF is equivalent to a relaxation of
kernel k-means / normalized cut (Ding et al. 2005), but inherits NMF's
interpretability: memberships are nonnegative and additive.

Update rule (Ding et al. 2005 eq. 11, the alpha = 1/2 damped form whose
fixed points are the symmetric KKT points):

    H <- H * (1/2 + 1/2 * (A H) / (H (H' H)))

Device notes: one (n, n) x (n, k) product (A H) plus (k, k) Gram work per
iteration — matmul-dense, no reconstruction of H H' is ever materialized;
the cost uses the Gram identity ||A - H H'||^2 = ||A||^2
- 2 <A H, H> + ||H'H||^2, whose f32 cancellation floor is
~||A||^2 * eps_f32 (late-plateau cost entries can tick up by that much
in f32 — same caveat as the flagship Gram cost, bench.py; run f64 for
strict monotonicity).  Mesh: A and H shard over rows; the (k, k) Gram
reductions psum over the mesh.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, merge_config, resolve_dtype,
                    uniform_init)
from ..ops import loop as looplib
from ..parallel import apply_placements, pad_axes


class _Spec(NamedTuple):
    maxiter: int
    eps: float


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    @jax.jit
    def solve(A, H0, tolerance):
        dt = A.dtype
        eps = jnp.asarray(spec.eps, dt)
        a_sq = jnp.sum(A * A)

        def products(H):
            AH = jax.lax.dot(A, H, preferred_element_type=dt)
            return AH, H.T @ H

        def step(carry, i):
            # AH/G ride the carry: the cost-side products of one
            # iteration ARE the next iteration's update inputs, so the
            # dominant (n, n) x (n, k) product runs ONCE per iteration.
            H, AH, G = carry
            HG = jax.lax.dot(H, G, preferred_element_type=dt)
            H = H * (0.5 + 0.5 * (AH / jnp.maximum(HG, eps)))
            AH, G = products(H)
            # cost via the Gram identity (no n x n reconstruction); the
            # clamp guards f32 cancellation exactly like
            # ops/gram.euclidean_cost_gram
            c = jnp.maximum(0.5 * (a_sq - 2.0 * jnp.sum(AH * H)
                                   + jnp.sum(G * G)), 0.0)
            return (H, AH, G), c, jnp.asarray(False)

        AH0, G0 = products(H0)
        return looplib.run(step, (H0, AH0, G0), spec.maxiter, tolerance,
                           cost_dtype=dt)
    return solve


def symnmf(A, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Symmetric NMF A ~ H H'.  Returns Result with H (n, k) and cost.

    Parameters: H_init (n, k; default scaled uniform — the classic
    sqrt(mean(A)/k) scale so H H' starts at A's magnitude), maxiter
    (100), tolerance (1e-3), seed, dtype, eps, mesh (rows of A and H
    shard together).  A must be square, nonnegative, and symmetric
    (checked to 1e-5 relative; pass (A + A.T)/2 to symmetrize).

    Cluster assignments: ``np.argmax(res.H, axis=1)``.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(A, cfg.get("dtype"))
    A = np.asarray(A, dtype)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"symnmf expects a square similarity matrix; "
                         f"got {A.shape}")
    n = A.shape[0]
    if A.min() < 0:
        raise ValueError("symnmf expects a nonnegative similarity matrix")
    asym = float(np.max(np.abs(A - A.T)))
    if asym > 1e-5 * max(float(np.max(np.abs(A))), 1e-30):
        raise ValueError(
            f"A is not symmetric (max |A - A'| = {asym:g}); symmetrize "
            "with (A + A.T) / 2 first")
    k = int(num_basis_elems)
    maxiter, tolerance, eps, key = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        # scale so that H0 @ H0.T matches A's mean magnitude (standard
        # SymNMF practice; a poorly scaled init stalls the damped update)
        scale = np.sqrt(max(float(A.mean()), 1e-30) / k)
        H0 = uniform_init(key, (n, k), dtype) * (2.0 * scale)
    H0 = jnp.asarray(H0, dtype)
    if H0.shape != (n, k):
        raise ValueError(f"H_init has shape {H0.shape}, expected {(n, k)}")

    A = jnp.asarray(A)
    mesh = cfg.get("mesh")
    pad = 0
    if mesh is not None:
        # A must stay square (A @ H contracts its column axis against
        # H's rows), so pad BOTH axes by the same amount: the smallest
        # making n divisible by every mesh axis.  Zero padding is exact:
        # padded rows of H start at 0 and stay 0 (multiplicative), and
        # zero rows/columns contribute nothing to AH, the Grams, or the
        # cost.
        import math
        from ..parallel import mesh_multiples, pad_amount
        mmul, nmul = mesh_multiples(mesh)
        pad = pad_amount(n, math.lcm(mmul, nmul))
        if pad:
            A = pad_axes(A, {0: pad, 1: pad})
            H0 = pad_axes(H0, {0: pad})
    A, H0 = apply_placements(mesh, "symnmf", A=A, H=H0)

    out = _build_solver(_Spec(maxiter, eps))(A, H0,
                                             jnp.asarray(tolerance, dtype))
    H = out.state[0]
    if pad:
        H = H[:n]
    return Result(
        fields=("H", "cost"),
        H=H,
        cost=looplib.trim_cost(out, maxiter),
        n_iters=int(out.n_iters), converged=bool(out.stopped),
    )
