"""Hoyer's L1/L2 sparsity projection, vectorized for the accelerator.

Solves, for each column s of S: find v minimizing ||v - s||_2 subject to
sum(v) = k1, sum(v^2) = k2, v >= 0.  Reference: projfunc.m (Hoyer 2004).

The reference projects one vector at a time with a data-dependent loop
(each pass zeroes at least one more coefficient, so it terminates in at
most N passes).  Here all B columns are projected together inside one
``lax.while_loop`` with per-column done-masking — converged columns are
frozen while stragglers keep iterating (SURVEY.md section 7 "Hard parts").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def project_columns(S, k1, k2, valid: int | None = None):
    """Project every column of S (N, B) onto {sum=k1, sum of squares=k2, >=0}.

    k1/k2 may be scalars or per-column (B,) vectors.  Returns (V, iters)
    where iters is the per-column pass count (projfunc.m `usediters`).

    ``valid`` handles mesh-padded vectors (parallel/padding.py): only the
    first ``valid`` rows form the true vector; the pad rows enter the loop
    pre-zeroed (the algorithm's own "clamped coefficient" state), so every
    sum, midpoint and redistribution divides by the TRUE vector length and
    the result is bit-compatible with projecting the unpadded vector.
    """
    S = jnp.asarray(S)
    N, B = S.shape
    dt = S.dtype
    k1 = jnp.broadcast_to(jnp.asarray(k1, dt), (B,))
    k2 = jnp.broadcast_to(jnp.asarray(k2, dt), (B,))

    if valid is None or valid >= N:
        row_valid = None
        n_eff = N
        # Initial projection onto the sum hyperplane (projfunc.m:22).
        v0 = S + (k1 - jnp.sum(S, axis=0)) / N
        zero0 = jnp.zeros((N, B), dtype=bool)
    else:
        row_valid = (jnp.arange(N) < valid)[:, None]
        n_eff = valid
        Sm = jnp.where(row_valid, S, jnp.zeros((), dt))
        v0 = jnp.where(row_valid,
                       Sm + (k1 - jnp.sum(Sm, axis=0)) / n_eff,
                       jnp.zeros((), dt))
        # Pad rows are permanently "zeroed coefficients": excluded from the
        # midpoint via the nz count and pinned at 0 by the clamp/where.
        zero0 = jnp.broadcast_to(~row_valid, (N, B))
    done0 = jnp.zeros((B,), dtype=bool)
    iters0 = jnp.zeros((B,), dtype=jnp.int32)

    def cond(carry):
        _, _, done, _, j = carry
        return jnp.logical_and(~jnp.all(done), j < N + 1)

    def body(carry):
        v, zero, done, iters, j = carry
        nz = jnp.sum(zero, axis=0)
        # Projection to the L2 sphere along the hyperplane (projfunc.m:31-38).
        midpoint = jnp.where(zero, jnp.zeros((), dt), (k1 / (N - nz))[None, :])
        w = v - midpoint
        a = jnp.sum(w * w, axis=0)
        b = 2.0 * jnp.sum(w * v, axis=0)
        c = jnp.sum(v * v, axis=0) - k2
        # real(sqrt(.)) of a negative discriminant is 0 in MATLAB.
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        alphap = (-b + jnp.sqrt(disc)) / (2.0 * a)
        v_proj = alphap[None, :] * w + v

        ok = jnp.all(v_proj >= 0, axis=0)  # projfunc.m:40-44

        # Zero-clamp and redistribute for the still-negative columns
        # (projfunc.m:49-53).
        zero_new = zero | (v_proj <= 0)
        nz2 = jnp.sum(zero_new, axis=0)
        v_cl = jnp.where(zero_new, jnp.zeros((), dt), v_proj)
        v_re = v_cl + ((k1 - jnp.sum(v_cl, axis=0)) / (N - nz2))[None, :]
        v_re = jnp.where(zero_new, jnp.zeros((), dt), v_re)

        v_next = jnp.where(done[None, :], v,
                           jnp.where(ok[None, :], v_proj, v_re))
        zero_next = jnp.where((done | ok)[None, :], zero, zero_new)
        iters_next = jnp.where(done, iters, iters + 1)
        return v_next, zero_next, done | ok, iters_next, j + 1

    v, _, _, iters, _ = jax.lax.while_loop(
        cond, body, (v0, zero0, done0, iters0, jnp.int32(0))
    )
    return v, iters


def projfunc(s, k1, k2, nonneg: bool = True):
    """Single-vector API matching the reference signature (projfunc.m:1).

    When ``nonneg`` is False, signs are recorded, the projection runs on
    |s|, and signs are restored (projfunc.m:15-19, 57-60).
    """
    s = jnp.asarray(s)
    flat = s.reshape(-1)
    if nonneg:
        v, iters = project_columns(flat[:, None], k1, k2)
        return v[:, 0].reshape(s.shape), iters[0]
    signs = jnp.where(flat < 0, -1.0, 1.0).astype(flat.dtype)
    v, iters = project_columns(jnp.abs(flat)[:, None], k1, k2)
    return (signs * v[:, 0]).reshape(s.shape), iters[0]


def hoyer_l1_target(dim: int, sparseness: float) -> float:
    """L1 target for unit-L2 vectors at a given Hoyer sparseness in [0, 1].

    Reference: nmfsc.m:93,106 — sqrt(d) - (sqrt(d) - 1) * s.
    """
    import math
    return math.sqrt(dim) - (math.sqrt(dim) - 1.0) * sparseness
