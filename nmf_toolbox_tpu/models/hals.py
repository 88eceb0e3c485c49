"""HALS NMF (Cichocki & Phan 2009) — a beyond-the-reference extra.

The reference toolbox only offers multiplicative updates; for the
Euclidean objective, Hierarchical ALS converges in far fewer iterations
(each sweep solves every rank-1 subproblem exactly), so time-to-tolerance
drops well below the MU solvers even at identical per-iteration cost —
the per-sweep heavy work is the SAME two Gram products as the MU Gram
path (V H' and W'V), plus a k-step `fori_loop` of rank-1 column/row
refinements.

This is additive API surface (the ``nmf`` solver stays exactly
reference-parity); use it when you want the best factorization per
wall-clock second rather than MATLAB-trajectory compatibility.
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
from ..ops.gram import euclidean_cost_gram, sq_norm
from ..ops.normalize import unit_l2_columns
from ..parallel import apply_placements


class _Spec(NamedTuple):
    maxiter: int
    k: int
    eps: float
    inner: int = 1  # accelerated-HALS inner sweep repetitions
    extrapolate: bool = False  # Ang & Gillis 2019 momentum scheme
    weighted: bool = False     # per-entry weighted objective


@functools.lru_cache(maxsize=None)
def _build_weighted_solver(spec: _Spec):
    """Weighted HALS: exact rank-1 coordinate solves of the per-entry
    weighted Euclidean objective 0.5*sum(M * (V - W H)^2).

    The weighted rank-1 subproblem has the closed form (for column j
    of W, with the UNMASKED residual R = V - W H maintained in the
    carry — rank-1 updates to it are exact, and masking it would square
    non-binary weights):

        d_i = sum_l M_il h_jl^2           (per-ROW denominators — the
                                           weights break the separable
                                           diag(HH') structure)
        w_i = max((((M*R) h_j)_i + w_ij d_i) / d_i, eps)
        R  -= outer(w_new - w_old, h_j)

    Each column costs two O(mn) elementwise passes + two matvecs, so a
    full sweep is O(mnk) — the same order as ONE weighted-MU iteration
    (whose masked matmuls are also mnk) while converging in several
    times fewer sweeps (see tests/test_hals.py).  Entries with weight 0
    never touch the objective, so NaN there cannot propagate (V is
    hard-zeroed at zero weights before the loop, as in the MU path).
    """
    k = spec.k

    @jax.jit
    def solve(V, M, W0, H0, tolerance):
        dt = V.dtype
        eps = jnp.asarray(spec.eps, dt)
        V = jnp.where(M > 0, V, 0.0)  # NaN-at-zero-weight safety

        # R = V - W H is carried UNMASKED (rank-1 updates to it are
        # exact); the weights enter only the numerators/denominators and
        # the cost, which is correct for arbitrary nonneg weights (a
        # masked residual would square M for non-binary weights).
        def step(carry, i):
            W, H, R = carry
            # denominators are loop-invariant within each half-sweep (the
            # OTHER factor is fixed): one batched matmul instead of k
            # serialized matvecs inside the fori_loop
            Dw = jnp.maximum(M @ (H * H).T, eps)        # (m, k)

            def w_col(j, WR):
                W, R = WR
                hj = H[j, :]
                w_new = jnp.maximum(
                    ((M * R) @ hj + W[:, j] * Dw[:, j]) / Dw[:, j], eps)
                R = R - jnp.outer(w_new - W[:, j], hj)
                return W.at[:, j].set(w_new), R

            W, R = jax.lax.fori_loop(0, k, w_col, (W, R))
            Dh = jnp.maximum((W * W).T @ M, eps)        # (k, n)

            def h_row(j, HR):
                H, R = HR
                wj = W[:, j]
                h_new = jnp.maximum(
                    (wj @ (M * R) + H[j, :] * Dh[j, :]) / Dh[j, :], eps)
                R = R - jnp.outer(wj, h_new - H[j, :])
                return H.at[j, :].set(h_new), R

            H, R = jax.lax.fori_loop(0, k, h_row, (H, R))
            c = 0.5 * jnp.sum(M * R * R)
            return (W, H, R), c, jnp.asarray(False)

        R0 = V - W0 @ H0
        return looplib.run(step, (W0, H0, R0), spec.maxiter, tolerance,
                           cost_dtype=dt, inclusive=True)
    return solve


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    k = spec.k

    @jax.jit
    def solve(V, W0, H0, tolerance, Wy0=None, Hy0=None, beta0=None,
              beta_bar0=None, prev_err0=None):
        dt = V.dtype
        eps = jnp.asarray(spec.eps, dt)
        v_sq = sq_norm(V)

        def step(carry, i):
            W, H = carry
            # --- W sweep: exact rank-1 updates, columns in sequence ---
            # Accelerated HALS (Gillis & Glineur 2012, arXiv:1107.5194):
            # VHt / HHt depend only on V and the fixed H, so the sweep can
            # repeat `inner` times reusing them; each extra sweep costs
            # m-by-k^2 instead of the m-by-n-by-k V dot.
            HHt = H @ H.T
            VHt = V @ H.T                          # [mnk]
            diagH = jnp.maximum(jnp.diag(HHt), eps)

            def w_col(j, W):
                wj = W[:, j] + (VHt[:, j] - W @ HHt[:, j]) / diagH[j]
                return W.at[:, j].set(jnp.maximum(wj, eps))

            for _ in range(spec.inner):
                W = jax.lax.fori_loop(0, k, w_col, W)
            # --- H sweep ---
            WtW = W.T @ W
            WtV = W.T @ V                          # [mnk]
            diagW = jnp.maximum(jnp.diag(WtW), eps)

            def h_row(j, H):
                hj = H[j, :] + (WtV[j, :] - WtW[j, :] @ H) / diagW[j]
                return H.at[j, :].set(jnp.maximum(hj, eps))

            for _ in range(spec.inner):
                H = jax.lax.fori_loop(0, k, h_row, H)
            c = euclidean_cost_gram(v_sq, WtV, WtW, H)
            return (W, H), c, jnp.asarray(False)

        if not spec.extrapolate:
            # inclusive stop rule: HALS can drive the clamped Gram cost
            # to exactly 0 (perfect fit at the dtype's precision floor),
            # where the reference's strict '<' could never fire again.
            return looplib.run(step, (W0, H0), spec.maxiter, tolerance,
                               cost_dtype=dt, inclusive=True)

        # ---- Extrapolated HALS (Ang & Gillis 2019, arXiv:1805.06604,
        # Algorithm 3 adapted): the sweeps run against EXTRAPOLATED
        # iterates Wy/Hy = X_new + beta (X_new - X_old); beta grows
        # geometrically while the (surrogate) objective decreases and a
        # restart drops the momentum when it increases.  Per-iteration
        # cost is the same two V-dots as plain HALS plus elementwise
        # extrapolation — the speedup is pure iteration-count.
        GAMMA, GAMMA_BAR, ETA = 1.05, 1.01, 1.5

        def step_ex(carry, i):
            W, H, Wy, Hy, beta, beta_bar, prev_err = carry
            # --- H sweeps against the extrapolated basis Wy ---
            WtW = Wy.T @ Wy
            WtV = Wy.T @ V                         # [mnk]
            diagW = jnp.maximum(jnp.diag(WtW), eps)
            Hn = Hy

            def h_row(j, Hc):
                hj = Hc[j, :] + (WtV[j, :] - WtW[j, :] @ Hc) / diagW[j]
                return Hc.at[j, :].set(jnp.maximum(hj, eps))

            for _ in range(spec.inner):
                Hn = jax.lax.fori_loop(0, k, h_row, Hn)
            Hy_n = Hn + beta * (Hn - H)
            # --- W sweeps against the extrapolated encoding Hy_n ---
            HHt = Hy_n @ Hy_n.T
            VHt = V @ Hy_n.T                       # [mnk]
            diagH = jnp.maximum(jnp.diag(HHt), eps)
            Wn = Wy

            def w_col(j, Wc):
                wj = Wc[:, j] + (VHt[:, j] - Wc @ HHt[:, j]) / diagH[j]
                return Wc.at[:, j].set(jnp.maximum(wj, eps))

            for _ in range(spec.inner):
                Wn = jax.lax.fori_loop(0, k, w_col, Wn)
            Wy_n = Wn + beta * (Wn - W)
            # Surrogate objective from the already-computed Grams:
            # 0.5||V - Wy Hn||^2 (the subproblem the H sweep just
            # solved) — the restart signal and reported trace, one k x k
            # contraction instead of a third V-dot (see docstring).
            err = euclidean_cost_gram(v_sq, WtV, WtW, Hn)
            worse = err > prev_err
            # restart: drop momentum, shrink beta; else grow toward cap
            beta_n = jnp.where(worse, beta / ETA,
                               jnp.minimum(beta_bar, beta * GAMMA))
            beta_bar_n = jnp.where(worse, beta,
                                   jnp.minimum(1.0, beta_bar * GAMMA_BAR))
            Wy_n = jnp.where(worse, Wn, Wy_n)
            Hy_n = jnp.where(worse, Hn, Hy_n)
            return (Wn, Hn, Wy_n, Hy_n, beta_n, beta_bar_n, err), err, \
                jnp.asarray(False)

        # momentum state is resumable (Result.resume_state): a chunked
        # run continuing from these is identical to an uninterrupted one
        state0 = (W0, H0, Wy0, Hy0, beta0, beta_bar0, prev_err0)
        return looplib.run(step_ex, state0, spec.maxiter, tolerance,
                           cost_dtype=dt, inclusive=True)
    return solve


def nmf_hals(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Euclidean NMF via HALS.  Returns Result as (W, H, cost).

    Parameters: W_init, H_init, maxiter (100), tolerance (1e-3), seed,
    dtype, mesh.  The convergence rule and cost trace semantics match the
    framework's other solvers (0.5*||V - WH||^2 after each sweep).

    ``extrapolate=True`` enables the Ang & Gillis (2019) momentum scheme
    — same per-iteration cost; measured on synthetic low-rank problems
    it reaches ~15-30% lower objective at equal iteration count and a
    better final plateau.  Its cost trace reports the surrogate objective
    0.5||V - Wy H||^2 evaluated against the extrapolated basis (the
    restart signal; within O(beta * step) of the true objective) — the
    returned factors W/H are the feasible iterates.
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    H0 = cfg.get("H_init")
    init = str(cfg.get("init", "random"))
    if init != "random":
        if init not in ("nndsvd", "nndsvda", "nndsvdar"):
            raise ValueError(f"unknown init {init!r}; expected 'random', "
                             "'nndsvd', 'nndsvda', or 'nndsvdar'")
        if W0 is not None or H0 is not None:
            raise ValueError("init='nndsvd*' cannot be combined with "
                             "W_init/H_init")
        from ..utils.init import nndsvd, seedable
        cdt = jnp.promote_types(dtype, jnp.float32)
        Vs = seedable(V) if cfg.get("weights") is not None else V
        W0, H0 = nndsvd(Vs.astype(cdt), k, key=key, variant=init)
    if W0 is None:
        W0 = unit_l2_columns(uniform_init(kw, (m, k), dtype))
    if H0 is None:
        H0 = uniform_init(kh, (k, n), dtype)
    W0 = jnp.asarray(W0, dtype)
    H0 = jnp.asarray(H0, dtype)

    V, W0, H0 = apply_placements(cfg.get("mesh"), "nmf", V=V, W=W0, H=H0)

    inner = cfg.get("inner_iters", 1)
    inner = 1 if inner is None else int(inner)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    weights = cfg.get("weights")
    extrapolate = bool(cfg.get("extrapolate", False))
    tol = jnp.asarray(tolerance, dtype)
    resume_state = None
    if weights is not None:
        # weighted rank-1 coordinate solves (see _build_weighted_solver)
        if extrapolate:
            raise ValueError("extrapolate=True is not supported together "
                             "with weights=")
        if inner != 1:
            raise ValueError("inner_iters > 1 is not supported with "
                             "weights= (the masked residual changes "
                             "every sweep)")
        from ..parallel import prepare_weights
        M = prepare_weights(weights, dtype, (m, n), cfg.get("mesh"),
                            "nmf", 0, 0, None)
        spec = _Spec(maxiter, k, eps, 1, False, True)
        out = _build_weighted_solver(spec)(V, M, W0, H0, tol)
    elif extrapolate:
        spec = _Spec(maxiter, k, eps, inner, True)
        # momentum state rides through resume_state so chunked runs
        # (utils/checkpoint.run_checkpointed) continue exactly
        rs = cfg.get("resume_state") or None
        if rs is not None:
            mom = (jnp.asarray(rs["Wy"], dtype), jnp.asarray(rs["Hy"], dtype),
                   jnp.asarray(float(rs["beta"]), dtype),
                   jnp.asarray(float(rs["beta_bar"]), dtype),
                   jnp.asarray(float(rs["prev_err"]), dtype))
        else:
            mom = (W0, H0, jnp.asarray(0.5, dtype), jnp.asarray(1.0, dtype),
                   jnp.asarray(np.finfo(np.dtype(dtype)).max, dtype))
        out = _build_solver(spec)(V, W0, H0, tol, *mom)
        st = out.state
        resume_state = {"Wy": np.asarray(st[2]), "Hy": np.asarray(st[3]),
                        "beta": float(st[4]), "beta_bar": float(st[5]),
                        "prev_err": float(st[6])}
    else:
        spec = _Spec(maxiter, k, eps, inner)
        out = _build_solver(spec)(V, W0, H0, tol)
    W, H = out.state[0], out.state[1]
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=int(out.n_iters), converged=bool(out.stopped),
                  resume_state=resume_state)
