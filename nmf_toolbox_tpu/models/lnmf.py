"""Local NMF (Li et al. 2001) — KL-based, column-sum-1 basis.

Accelerator re-design of lnmf.m.  Distinctives preserved from the
reference: the sqrt H update (lnmf.m:81), the column-sum normalization of
W (lnmf.m:64,75), the <=-style convergence comparison, and the quirk that
the cost vector is NOT trimmed on early exit (lnmf.m:89-91).

Device notes: the W-update denominator ones(m,n) @ H' (lnmf.m:74) is a
broadcast of H's row sums — no m-by-n ones matrix is ever built.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, merge_config, parse_cost_every,
                    resolve_dtype, uniform_init)
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_sum_columns
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    w_fixed: bool
    h_fixed: bool
    eps: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    cost_every: int = 1  # objective cadence (1 = reference semantics)


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    @jax.jit
    def solve(V, W0, H0, tolerance):
        eps = jnp.asarray(spec.eps, V.dtype)
        mask = region_mask(V.shape, spec.valid)
        zero = jnp.zeros((), V.dtype)

        def ratio(V_hat):
            r = V / V_hat
            return r if mask is None else jnp.where(mask, r, zero)

        # Precompute the constant part of the KL cost.
        vlv = V * jnp.log(V)
        if mask is not None:
            vlv = jnp.where(mask, vlv, zero)
        v_logv = jnp.sum(vlv) - jnp.sum(V)

        ce = int(spec.cost_every)
        cadence = looplib.cost_cadence(ce, spec.maxiter)

        def step(carry, i):
            W, H = carry[0], carry[1]
            if not spec.w_fixed:
                V_hat = W @ H
                h_rowsum = jnp.sum(H, axis=1)  # ones(m,n) @ H' (lnmf.m:74)
                W = W * ((ratio(V_hat) @ H.T) / jnp.maximum(h_rowsum[None, :], eps))
                W = unit_sum_columns(W)
            if not spec.h_fixed:
                V_hat = W @ H
                H = jnp.sqrt(H * (W.T @ ratio(V_hat)))  # lnmf.m:81

            def cost_fn(W=W, H=H):
                # The objective's V_hat = W @ H is a THIRD full matmul
                # each iteration (plus the log-field pass) whose only
                # consumer is the stop rule — cost_every > 1 skips all
                # of it.  NOTE: run() gates the inclusive <= stop rule
                # to check points (a carried cost would satisfy
                # 0 <= tol every skipped iteration otherwise).
                V_hat = W @ H
                vlvh = V * jnp.log(V_hat)
                if mask is not None:
                    vlvh = jnp.where(mask, vlvh, zero)
                return v_logv - jnp.sum(vlvh) + jnp.sum(V_hat)

            return cadence((W, H), carry, i, cost_fn)

        return looplib.run(step, looplib.cadence_state((W0, H0), ce,
                                                       V.dtype),
                           spec.maxiter, tolerance,
                           inclusive=True, cost_dtype=V.dtype,
                           cost_every=ce)
    return solve


def lnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Local NMF; returns Result unpacking as (W, H, cost).

    Parameters (lnmf.m:96-134): W_init, H_init, W_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  Extras: dtype, seed, eps,
    cost_every (objective cadence — the objective's V_hat is a third
    full matmul per iteration, all stop-rule-only work; the inclusive
    <= stop rule is checked only on computed objectives).
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(kw, (m, k), dtype)
        W0 = unit_sum_columns(W0)  # lnmf.m:112-113
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(kh, (k, n), dtype)
    W0 = unit_sum_columns(jnp.asarray(W0, dtype))  # lnmf.m:64
    H0 = jnp.asarray(H0, dtype)

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "lnmf", V=V, W=W0, H=H0)

    spec = _Spec(maxiter, bool(cfg.get("W_fixed", False)),
                 bool(cfg.get("H_fixed", False)), eps, valid,
                 parse_cost_every(cfg))
    out = _build_solver(spec)(V, W0, H0, jnp.asarray(tolerance, dtype))
    W, H = out.state[0], out.state[1]
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=looplib.trim_cost(out, maxiter, trim=False),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
