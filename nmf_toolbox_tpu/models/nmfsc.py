"""NMF with sparseness constraints (Hoyer 2004).

Accelerator re-design of nmfsc.m.  Structure preserved from the reference:
Euclidean only, single source; sparsity in [0, 1] maps to an L1 target for
unit-L2 vectors (nmfsc.m:93,106); sparse factors move by projected
gradient descent with a backtracking line search (halve until the
objective decreases, grow 1.2x on success, declare convergence when the
stepsize underflows 1e-200 — nmfsc.m:148-233); non-sparse factors fall
back to plain MU with an H-row renormalization that transfers norms into
W (nmfsc.m:182-187).

Device-first details:
* the line-search objective 0.5*||V - W Hnew||^2 is evaluated in Gram
  form — W is frozen during the H search, so each trial costs O(n k^2)
  instead of a full m-by-n reconstruction (nmfsc.m:160-161); same for the
  W search with H frozen.
* each trial projects ALL rows/columns at once through the vectorized
  Hoyer projection (ops/projection.py).
* both line searches are bounded ``lax.while_loop``s nested inside the
  on-device outer iteration loop.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import common_scalars, ingest_rescaled, Result, merge_config, \
    resolve_dtype
from ..ops import loop as looplib
from ..ops.projection import hoyer_l1_target, project_columns
from ..ops.normalize import row_l2_transfer
from ..ops.linesearch import make_search, resolve_width
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    w_sparse: bool
    h_sparse: bool
    w_fixed: bool
    h_fixed: bool
    eps: float
    l1_w: float
    l1_h: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    ls_width: int = 0    # 0 = sequential halving; >0 = parallel backtracking


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    @jax.jit
    def solve(V, W0, H0, tolerance, st_w0, st_h0):
        dt = V.dtype
        eps = jnp.asarray(spec.eps, dt)
        v_sq = jnp.sum(V * V)
        one = jnp.ones((), dt)

        def obj_h(WtV, WtW):
            # 0.5||V - W H||^2 with W frozen (Gram form)
            def f(H):
                return 0.5 * (v_sq - 2.0 * jnp.sum(WtV * H)
                              + jnp.sum((WtW @ H) * H))
            return f

        def obj_w(VHt, HHt):
            def f(W):
                return 0.5 * (v_sq - 2.0 * jnp.sum(VHt * W)
                              + jnp.sum((W.T @ W) * HHt))
            return f

        # Hoyer projections of mesh-padded vectors run with the TRUE
        # vector length (pad rows enter pre-zeroed — ops/projection.py).
        mv, nv = spec.valid if spec.valid is not None else (None, None)
        search = make_search(spec.ls_width)

        def proj_rows(H):
            return project_columns(H.T, spec.l1_h, one, valid=nv)[0].T

        def proj_cols(W):
            return project_columns(W, spec.l1_w, one, valid=mv)[0]

        def initial_cost(W, H):
            WtV = W.T @ V
            WtW = W.T @ W
            return jnp.maximum(  # clamp: see ops/gram.euclidean_cost_gram
                0.5 * (v_sq - 2.0 * jnp.sum(WtV * H) + jnp.sum((WtW @ H) * H)),
                0.0)

        def step(carry, i):
            W, H, step_w, step_h, prev_cost = carry
            term = jnp.asarray(False)

            # ---- H update (nmfsc.m:143-189) ----
            if not spec.h_fixed:
                WtV = W.T @ V
                WtW = W.T @ W
                if spec.h_sparse:
                    dH = WtW @ H - WtV  # positive_grad - negative_grad
                    H, step_h, under_h, _ = search(
                        obj_h(WtV, WtW), H, dH, step_h, proj_rows, prev_cost)
                    term = term | under_h
                else:
                    H = H * (WtV / jnp.maximum(WtW @ H, eps))
                    H, W_scaled = row_l2_transfer(H, W)
                    W = W_scaled

            # ---- W update (nmfsc.m:192-233) ----
            if not spec.w_fixed:
                HHt = H @ H.T
                VHt = V @ H.T
                if spec.w_sparse:
                    f_w = obj_w(VHt, HHt)
                    begobj = f_w(W)  # nmfsc.m:197 (fresh objective)
                    dW = W @ HHt - VHt
                    W1, step_w1, under_w, _ = search(
                        f_w, W, dW, step_w, proj_cols, begobj)
                    # discard the W phase entirely if the H search already
                    # terminated (the reference returned before reaching it)
                    W = jnp.where(term, W, W1)
                    step_w = jnp.where(term, step_w, step_w1)
                    term = term | (under_w & ~term)
                else:
                    Wn = W * (VHt / jnp.maximum(W @ HHt, eps))
                    W = jnp.where(term, W, Wn)

            c = initial_cost(W, H)  # nmfsc.m:237-238
            return (W, H, step_w, step_h, c), c, term

        c0 = initial_cost(W0, H0)
        return looplib.run(step, (W0, H0, st_w0, st_h0, c0), spec.maxiter,
                           tolerance, offset=1, initial_cost=c0,
                           cost_dtype=dt)
    return solve


def nmfsc(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Hoyer sparse NMF.  Returns Result as (W, H, cost).

    Parameters (nmfsc.m:9-41): W_init, H_init, W_sparsity/H_sparsity in
    [0, 1] (Hoyer sparseness, clamped to 1 — nmfsc.m:90-92), W_fixed,
    H_fixed, maxiter (100), tolerance (1e-3).  V must be non-negative; it
    is rescaled by its max (nmfsc.m:57-62).  cost[0] is the initial cost
    (length maxiter+1 semantics, nmfsc.m:137-139).
    """
    cfg = merge_config(config, kwargs)
    dispatch = cfg.pop("dispatch", None)
    if dispatch == "phased":
        # Host-driven phase-split dispatch with bounded device programs
        # (bit-identical trajectory) — see models/nmfsc_phased.py.
        from .nmfsc_phased import nmfsc_phased
        return nmfsc_phased(V, num_basis_elems, cfg)
    if dispatch not in (None, "fused"):
        raise ValueError(f"unknown dispatch {dispatch!r}; "
                         "use 'fused' (default) or 'phased'")
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = ingest_rescaled(V, dtype)  # nmfsc.m:57-62, device-resident
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, eps, key = common_scalars(cfg)
    w_sp = float(cfg.get("W_sparsity", 0.0) or 0.0)
    h_sp = float(cfg.get("H_sparsity", 0.0) or 0.0)
    w_sp = min(w_sp, 1.0)  # nmfsc.m:90-92
    h_sp = min(h_sp, 1.0)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = jax.random.uniform(kw, (m, k), dtype)  # nmfsc.m:73-75
    W0 = jnp.asarray(W0, dtype)
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = jax.random.uniform(kh, (k, n), dtype)
        H0 = H0 / jnp.sqrt(jnp.sum(H0 * H0, axis=1, keepdims=True))  # nmfsc.m:78-81
    H0 = jnp.asarray(H0, dtype)

    l1_w = hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0
    l1_h = hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0
    # Chunked continuation (utils/checkpoint.py): factors from a previous
    # run are already feasible — re-projecting them is only
    # fp-approximately idempotent and would perturb the trajectory — and
    # the line-search stepsizes resume where they left off
    # (nmfsc.m:147,178 stepsize growth/halving state).
    # empty dict == no resume (a fresh run), checked consistently
    rs = cfg.get("resume_state") or None
    st_w0 = float(rs["step_w"]) if rs is not None else 1.0
    st_h0 = float(rs["step_h"]) if rs is not None else 1.0
    if rs is None:
        if w_sp > 0:  # initial projection (nmfsc.m:93-96)
            W0 = project_columns(W0, l1_w, 1.0)[0]
        if h_sp > 0:  # nmfsc.m:106-109
            H0 = project_columns(H0.T, l1_h, 1.0)[0].T

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "nmfsc", V=V, W=W0, H=H0)

    spec = _Spec(maxiter, w_sp > 0, h_sp > 0,
                 bool(cfg.get("W_fixed", False)), bool(cfg.get("H_fixed", False)),
                 eps, float(l1_w), float(l1_h), valid,
                 resolve_width(cfg.get("linesearch_width"), mesh))
    # 'highest' matmul precision (no-op on CPU): the GPU's default float32
    # matmul rounds its operands to TF32 (10-bit mantissa), and the
    # cancellation-heavy Gram-form objectives amplify that relative
    # error ~10x at production shapes — enough to exceed late
    # line-search decreases and stall the acceptance test (see
    # models/nmfsc_phased.py).
    with jax.default_matmul_precision("highest"):
        out = _build_solver(spec)(V, W0, H0, jnp.asarray(tolerance, dtype),
                                  jnp.asarray(st_w0, dtype),
                                  jnp.asarray(st_h0, dtype))
    W, H = out.state[0], out.state[1]
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters),
                  converged=bool(out.stopped) or bool(out.terminated),
                  resume_state={"step_w": float(out.state[2]),
                                "step_h": float(out.state[3])})
