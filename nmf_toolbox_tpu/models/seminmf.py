"""Semi-NMF (Ding, Li & Jordan 2010): W unconstrained, H >= 0.

Accelerator re-design of seminmf.m: the exact W solve V H' / (H H')
(seminmf.m:68) becomes an LU solve of the k-by-k Gram on device; the
sqrt multiplicative H update uses pos/neg Gram splits (seminmf.m:73-77 —
note the reference has no eps guard here, preserved).  The Euclidean cost
is evaluated in Gram form (no m-by-n reconstruction).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import common_scalars, Result, merge_config, resolve_dtype
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, pos_neg_split, sq_norm
from ..ops.masking import col_mask
from ..utils.init import kmeans_indicator_h
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    w_fixed: bool
    h_fixed: bool
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    # v_sq arrives as an argument, following the gram-family convention
    # (convexnmf.py's rematerialization note: large loop-invariant
    # buffers MUST be executable arguments; a kept scalar is safe either
    # way, and hoisting it keeps one pattern across solvers).  Each
    # iteration does the two unavoidable m*n*k products (V H' and W'V).
    @jax.jit
    def solve(V, W0, H0, v_sq, tolerance):
        # Pad columns of the sqrt MU ratio are 0/0 (the reference's update
        # has no eps guard); pin them to zero so NaN never forms.
        cmask = col_mask(V.shape[1], None if spec.valid is None
                         else spec.valid[1])

        def step(carry, i):
            W, H = carry
            if not spec.w_fixed:
                # W = V H' (H H')^-1  (seminmf.m:68)
                HHt = H @ H.T
                VHt = V @ H.T
                # LU, not Cholesky: MATLAB's mrdivide (seminmf.m:68)
                # survives semi-definite-to-roundoff Grams with finite
                # values where a Cholesky solve returns NaN.
                W = jax.scipy.linalg.solve(HHt, VHt.T, assume_a="gen").T
            WtV = W.T @ V
            WtW = W.T @ W
            if not spec.h_fixed:
                wv_pos, wv_neg = pos_neg_split(WtV)
                ww_pos, ww_neg = pos_neg_split(WtW)
                # seminmf.m:73-77 (no eps guard in the reference)
                ratio = (wv_pos + ww_neg @ H) / (wv_neg + ww_pos @ H)
                if cmask is not None:
                    ratio = jnp.where(cmask[None, :], ratio,
                                      jnp.zeros((), ratio.dtype))
                H = H * jnp.sqrt(ratio)
            c = euclidean_cost_gram(v_sq, WtV, WtW, H)
            return (W, H), c, jnp.asarray(False)

        return looplib.run(step, (W0, H0), spec.maxiter, tolerance,
                           cost_dtype=V.dtype)
    return solve


def seminmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Semi-NMF; V may be mixed-sign.  Returns Result as (W, H, cost).

    Parameters (seminmf.m:99-144): W_init (default uniform in [-1, 1]),
    H_init (default kmeans indicator + 0.2), W_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  Extras: dtype, seed.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, _, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = kmeans_indicator_h(kh, V, k, dtype)  # seminmf.m:109-117
    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = 2.0 * jax.random.uniform(kw, (m, k), dtype) - 1.0  # seminmf.m:121
    W0 = jnp.asarray(W0, dtype)
    H0 = jnp.asarray(H0, dtype)

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "seminmf", V=V, W=W0, H=H0)

    spec = _Spec(maxiter, bool(cfg.get("W_fixed", False)),
                 bool(cfg.get("H_fixed", False)), valid)
    out = _build_solver(spec)(V, W0, H0, sq_norm(V),
                              jnp.asarray(tolerance, dtype))
    W, H = out.state
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=int(out.n_iters), converged=bool(out.stopped))
