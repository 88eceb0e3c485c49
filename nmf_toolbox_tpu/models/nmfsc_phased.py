"""Phase-split nmfsc dispatch: host outer loop, bounded device programs.

The default nmfsc solver (models/nmfsc.py) runs the entire iteration in
one compiled program: an outer ``lax.while_loop`` nesting two
backtracking line searches (each an unbounded ``while_loop``) nesting the
Hoyer projection (another ``while_loop``).  That program is unbounded:
one dispatch may run arbitrarily long, and nothing can be observed until
it ends.

This module is the restructured dispatch: the outer
iteration runs on the HOST, and every device program has statically
bounded control flow —

* ``lax.fori_loop`` with acceptance masks replaces both unbounded
  while_loops (line-search trials AND projection passes);
* the m x n data V is touched only by the two Gram programs and the cost
  program; line-search trial rounds operate purely on Gram-form
  quantities (k x n / m x k / k x k) and can be re-dispatched from the
  host until a trial is accepted or the stepsize underflows, carrying
  only (factor, stepsize, begobj) across the boundary — semantically
  identical to the unbounded search because masked extra trials and
  masked extra projection passes are exact no-ops.

Trajectories are BIT-IDENTICAL to the fused single-program path (pinned
by tests/test_nmfsc_phased.py) — it is the same math in the same order,
just partitioned differently.  The default fast path fuses the whole
iteration (both phases, one batched trial round each, cost) into ONE
dispatch with the flags+cost packed in a single small array, so the
host pays exactly one readback per iteration; a search needing more
than ``trials`` halvings falls back to per-phase programs with
unbounded continuation rounds (``fuse_iteration=False`` forces the
per-phase path everywhere).  This stays an opt-in ``dispatch='phased'``
because the host round-trip per iteration still loses to the fused
while_loop solver on low-latency backends (CPU).

Reference semantics: nmfsc.m:141-245 (line searches nmfsc.m:152-179 /
196-233, underflow return nmfsc.m:170-174, MU fallbacks nmfsc.m:182-187,
cost nmfsc.m:237-243); projection projfunc.m:28-55.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import Result, common_scalars, ingest_rescaled, \
    merge_config, resolve_dtype
from ..ops.normalize import row_l2_transfer
from ..ops.projection import hoyer_l1_target


class _PhSpec(NamedTuple):
    w_sparse: bool
    h_sparse: bool
    w_fixed: bool
    h_fixed: bool
    eps: float
    l1_w: float
    l1_h: float
    trials: int       # line-search trials per device round
    proj_passes: int  # Hoyer projection passes per trial (bounded fori)
    batched: bool = False  # vmapped trial rounds (ulp-level deviation)


def _project_columns_bounded(S, k1, k2, passes: int):
    """Hoyer projection with a static ``fori_loop`` trip count.

    Same per-pass math as ops/projection.project_columns (projfunc.m:
    28-55); converged columns are frozen by the done-mask, so any passes
    beyond a column's convergence are exact no-ops and the result is
    bit-identical to the while_loop version whenever ``passes`` covers
    the true pass count (each pass zeroes >= 1 more coefficient, so
    N+1 always suffices; in practice <= ~10).
    """
    S = jnp.asarray(S)
    N, B = S.shape
    dt = S.dtype
    k1 = jnp.broadcast_to(jnp.asarray(k1, dt), (B,))
    k2 = jnp.broadcast_to(jnp.asarray(k2, dt), (B,))
    v0 = S + (k1 - jnp.sum(S, axis=0)) / N
    zero0 = jnp.zeros((N, B), dtype=bool)
    done0 = jnp.zeros((B,), dtype=bool)

    def body(_, carry):
        v, zero, done = carry
        nz = jnp.sum(zero, axis=0)
        midpoint = jnp.where(zero, jnp.zeros((), dt), (k1 / (N - nz))[None, :])
        w = v - midpoint
        a = jnp.sum(w * w, axis=0)
        b = 2.0 * jnp.sum(w * v, axis=0)
        c = jnp.sum(v * v, axis=0) - k2
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        alphap = (-b + jnp.sqrt(disc)) / (2.0 * a)
        v_proj = alphap[None, :] * w + v
        ok = jnp.all(v_proj >= 0, axis=0)
        zero_new = zero | (v_proj <= 0)
        nz2 = jnp.sum(zero_new, axis=0)
        v_cl = jnp.where(zero_new, jnp.zeros((), dt), v_proj)
        v_re = v_cl + ((k1 - jnp.sum(v_cl, axis=0)) / (N - nz2))[None, :]
        v_re = jnp.where(zero_new, jnp.zeros((), dt), v_re)
        v_next = jnp.where(done[None, :], v,
                           jnp.where(ok[None, :], v_proj, v_re))
        zero_next = jnp.where((done | ok)[None, :], zero, zero_new)
        return v_next, zero_next, done | ok

    v, _, done = jax.lax.fori_loop(0, int(min(passes, N + 1)), body,
                                   (v0, zero0, done0))
    return v, done


def _bounded_search(obj_fn, X, dX, step0, project, begobj, trials: int):
    """K bounded trials of the backtracking search (nmfsc.m:152-179),
    executed sequentially inside a ``fori_loop`` with acceptance masks.

    Mirrors ops/linesearch.backtracking_search trial-for-trial, so the
    result is BIT-identical to the fused solver's search.  Returns
    (X_out, step_out, accepted, underflow, obj, proj_ok); neither
    accepted nor underflow after ``trials`` trials means the caller
    continues from the returned (halved) step — a pure continuation,
    since every trial starts from the same X.
    """
    dt = X.dtype
    from ..ops.linesearch import underflow_threshold
    under_thr = underflow_threshold(dt)

    def body(_, carry):
        step, Xb, obj, accepted, underflow, proj_ok = carry
        active = (~accepted) & (~underflow)
        Xnew, done = project(X - step * dX)
        newobj = obj_fn(Xnew)
        acc_t = newobj <= begobj
        step_next = jnp.where(acc_t, step, step / 2.0)
        under_t = (~acc_t) & (step_next < under_thr)
        return (jnp.where(active, step_next, step),
                jnp.where(active & acc_t, Xnew, Xb),
                jnp.where(active, newobj, obj),
                accepted | (active & acc_t),
                underflow | (active & under_t),
                proj_ok & jnp.where(active, jnp.all(done), True))

    step, Xn, obj, accepted, underflow, proj_ok = jax.lax.fori_loop(
        0, trials, body,
        (jnp.asarray(step0, dt), X, jnp.zeros((), dt),
         jnp.asarray(False), jnp.asarray(False), jnp.asarray(True)))
    X_out = jnp.where(accepted, Xn, X)
    step_out = jnp.where(accepted, 1.2 * step, step)
    return X_out, step_out, accepted, underflow, obj, proj_ok


def _batched_round(obj_fn, X, dX, step0, project, begobj, width: int):
    """One batched round of ``width`` step-halving candidates: all trial
    projections and objectives evaluate in a single vmapped pass, then
    the FIRST acceptable candidate in halving order wins, with an
    underflow strictly before it preempting (the sequential selection
    rule — same as ops/linesearch.parallel_backtracking_search).

    CAVEAT: XLA compiles the batched (J, ...) matmuls/reductions with
    different tiling than their single-candidate forms, so candidate
    values can differ from the sequential engine in the LAST ULPS
    (~1e-15 relative observed on CPU f64) — selection decisions are the
    same except at exactly-knife-edge acceptances.  Therefore this
    engine is opt-in (``batched_trials=True``); the default
    ``_bounded_search`` is bit-identical to the fused solver.

    Returns (X_out, step_out, accepted, underflow, obj, proj_ok);
    neither accepted nor underflow means the caller continues from the
    returned (steps[-1]/2) step — a pure continuation, since every
    trial starts from the same X.
    """
    dt = X.dtype
    from ..ops.linesearch import underflow_threshold
    under_thr = underflow_threshold(dt)
    halv = (0.5 ** jnp.arange(width)).astype(dt)
    steps = jnp.asarray(step0, dt) * halv
    Xc = X[None] - steps.reshape((-1,) + (1,) * X.ndim) * dX[None]
    Xp, done = jax.vmap(project)(Xc)
    objs = jax.vmap(obj_fn)(Xp)
    acc = objs <= begobj
    any_acc = jnp.any(acc)
    j_acc = jnp.argmax(acc)
    under = (steps / 2.0) < under_thr
    any_und = jnp.any(under)
    j_und = jnp.argmax(under)
    accepted = any_acc & ((~any_und) | (j_acc <= j_und))
    underflow = any_und & (~accepted)
    j = jnp.where(accepted, j_acc, jnp.where(underflow, j_und, width - 1))
    X_out = jnp.where(accepted, Xp[j], X)
    step_out = jnp.where(
        accepted, 1.2 * steps[j],
        jnp.where(underflow, steps[j] / 2.0, steps[width - 1] / 2.0))
    # sequential execution would only have evaluated candidates 0..j, so
    # only their projection convergence can matter
    ran = jnp.arange(width) <= j
    proj_ok = jnp.all(jnp.where(ran[:, None], done, True))
    return X_out, step_out, accepted, underflow, objs[j], proj_ok


@functools.lru_cache(maxsize=None)
def _build_phases(spec: _PhSpec):
    eps = spec.eps
    _round = _batched_round if spec.batched else _bounded_search

    def _proj_rows(l1):
        def p(H):
            v, done = _project_columns_bounded(H.T, l1, 1.0, spec.proj_passes)
            return v.T, done
        return p

    def _proj_cols(l1):
        def p(W):
            return _project_columns_bounded(W, l1, 1.0, spec.proj_passes)
        return p

    # All phase programs run their matmuls at 'highest' precision: the
    # Gram-form objective cancels v_sq (~4e6 at BASELINE #2) down to the
    # cost (~4e5), and the GPU's default float32 matmul (TF32 operands,
    # 10-bit mantissa) leaves noise of order 1e1-1e2 in it — larger than
    # late-iteration line-search decreases, which stalls the acceptance
    # test.  The flag is a no-op on CPU, preserving the bit-exact parity
    # pins.
    HIGHEST = "highest"

    @jax.jit
    def v_sq_fn(V):
        return jnp.sum(V * V)

    @jax.jit
    def h_grams(V, W):
        with jax.default_matmul_precision(HIGHEST):
            return W.T @ V, W.T @ W

    @jax.jit
    def h_round(v_sq, WtV, WtW, H, step_h):
        with jax.default_matmul_precision(HIGHEST):
            dH = WtW @ H - WtV

            def obj(Hn):
                return 0.5 * (v_sq - 2.0 * jnp.sum(WtV * Hn)
                              + jnp.sum((WtW @ Hn) * Hn))
            # begobj (= the previous cost, nmfsc.m:148) is re-derived by
            # the SAME expression the trial objectives use, so
            # per-program rounding bias cancels out of the acceptance
            # test; W is unchanged since that cost was computed, making
            # this value-identical to the carried prev_cost.
            return _round(obj, H, dH, step_h, _proj_rows(spec.l1_h),
                          obj(H), spec.trials)

    @jax.jit
    def h_mu(V, W, H):
        with jax.default_matmul_precision(HIGHEST):
            WtV = W.T @ V
            WtW = W.T @ W
            H = H * (WtV / jnp.maximum(WtW @ H, jnp.asarray(eps, H.dtype)))
            H, W = row_l2_transfer(H, W)
            return W, H

    @jax.jit
    def w_grams(V, H):
        with jax.default_matmul_precision(HIGHEST):
            return V @ H.T, H @ H.T

    @jax.jit
    def w_round(v_sq, VHt, HHt, W, step_w):
        with jax.default_matmul_precision(HIGHEST):
            dW = W @ HHt - VHt

            def obj(Wn):
                return 0.5 * (v_sq - 2.0 * jnp.sum(VHt * Wn)
                              + jnp.sum((Wn.T @ Wn) * HHt))
            # begobj = fresh objective at the current W (nmfsc.m:197),
            # evaluated in-program for bias-free acceptance.
            return _round(obj, W, dW, step_w, _proj_cols(spec.l1_w),
                          obj(W), spec.trials)

    @jax.jit
    def w_mu(V, W, H):
        with jax.default_matmul_precision(HIGHEST):
            HHt = H @ H.T
            VHt = V @ H.T
            return W * (VHt / jnp.maximum(W @ HHt, jnp.asarray(eps, W.dtype)))

    @jax.jit
    def cost_fn(V, W, H, v_sq):
        with jax.default_matmul_precision(HIGHEST):
            WtV = W.T @ V
            WtW = W.T @ W
            return jnp.maximum(
                0.5 * (v_sq - 2.0 * jnp.sum(WtV * H)
                       + jnp.sum((WtW @ H) * H)), 0.0)

    @jax.jit
    def iter_step(V, W, H, step_w, step_h, v_sq):
        """One FULL outer iteration in a single dispatch: H phase, W
        phase, and cost, with the flags and cost packed into one small
        array so the host pays exactly one readback per iteration
        (~7 host round-trips/iter -> 1).  Each line search gets ONE
        batched round of spec.trials candidates; if that neither
        accepts nor underflows (needs >trials halvings — rare, near
        termination) the h_more/w_more flag sends the host down the
        per-phase slow path, which redoes the whole iteration from the
        unchanged carry with as many continuation rounds as needed.
        Math and candidate selection are identical to the per-phase
        programs, so the trajectory stays bit-identical.
        """
        dt = V.dtype
        f = jnp.asarray(False)
        h_acc = h_und = h_more = w_acc = w_und = w_more = f
        pok1 = pok2 = jnp.asarray(True)
        with jax.default_matmul_precision(HIGHEST):
            if not spec.h_fixed:
                WtV = W.T @ V
                WtW = W.T @ W
                if spec.h_sparse:
                    dH = WtW @ H - WtV

                    def obj_h(Hn):
                        return 0.5 * (v_sq - 2.0 * jnp.sum(WtV * Hn)
                                      + jnp.sum((WtW @ Hn) * Hn))
                    H1, sh1, h_acc, h_und, _, pok1 = _round(
                        obj_h, H, dH, step_h, _proj_rows(spec.l1_h),
                        obj_h(H), spec.trials)
                    h_more = (~h_acc) & (~h_und)
                    H = jnp.where(h_acc, H1, H)
                    # underflow also commits the (halved) step, matching
                    # the sequential search's mid-iteration state
                    step_h = jnp.where(h_acc | h_und, sh1, step_h)
                else:
                    H = H * (WtV / jnp.maximum(WtW @ H,
                                               jnp.asarray(eps, dt)))
                    H, W = row_l2_transfer(H, W)
            term = h_und
            if not spec.w_fixed:
                VHt = V @ H.T
                HHt = H @ H.T
                if spec.w_sparse:
                    dW = W @ HHt - VHt

                    def obj_w(Wn):
                        return 0.5 * (v_sq - 2.0 * jnp.sum(VHt * Wn)
                                      + jnp.sum((Wn.T @ Wn) * HHt))
                    W1, sw1, w_acc, w_und, _, pok2 = _round(
                        obj_w, W, dW, step_w, _proj_cols(spec.l1_w),
                        obj_w(W), spec.trials)
                    w_more = (~term) & (~w_acc) & (~w_und)
                    w_und = (~term) & w_und
                    use = (~term) & w_acc
                    W = jnp.where(use, W1, W)
                    step_w = jnp.where(use | w_und, sw1, step_w)
                else:
                    Wn = W * (VHt / jnp.maximum(W @ HHt,
                                                jnp.asarray(eps, dt)))
                    W = jnp.where(term, W, Wn)
            WtVc = W.T @ V
            WtWc = W.T @ W
            cost = jnp.maximum(
                0.5 * (v_sq - 2.0 * jnp.sum(WtVc * H)
                       + jnp.sum((WtWc @ H) * H)), 0.0)
        # Projection-convergence flags only count for RESULTS the host
        # will actually use: a host redo (h_more/w_more) re-runs both
        # phases through the slow path (which re-checks), and an H
        # underflow (clean reference termination, nmfsc.m:170-174)
        # discards the speculative W phase entirely.
        redo = h_more | w_more
        pok = redo | (pok1 & (h_und | pok2))
        flags = jnp.stack([
            h_acc.astype(dt), h_und.astype(dt), h_more.astype(dt),
            w_acc.astype(dt), w_und.astype(dt), w_more.astype(dt),
            pok.astype(dt), cost])
        return W, H, step_w, step_h, flags

    return dict(v_sq=v_sq_fn, h_grams=h_grams, h_round=h_round, h_mu=h_mu,
                w_grams=w_grams, w_round=w_round, w_mu=w_mu, cost=cost_fn,
                iter=iter_step)


def _search_to_accept(round_fn, args, X, step, max_rounds=None):
    """Host loop re-dispatching bounded trial rounds until acceptance or
    underflow (the unbounded while of nmfsc.m:152-175, split at the
    dispatch boundary).  The round budget always covers halving from the
    current step all the way to the underflow threshold (~700 halvings
    from step 1 in f64), so a genuinely stuck search terminates exactly
    like the unbounded one instead of erroring."""
    if max_rounds is None:
        import math
        from ..ops.linesearch import underflow_threshold
        thr = underflow_threshold(X.dtype)
        halvings = math.log2(max(float(step), thr)) - math.log2(thr)
        max_rounds = int(halvings) + 8  # >= even if every round is 1 trial
    for _ in range(max_rounds):
        X_out, step, accepted, underflow, obj, proj_ok = round_fn(
            *args, X, step)
        if not bool(proj_ok):
            raise RuntimeError(
                "bounded Hoyer projection did not converge within "
                "proj_passes passes; raise nmfsc(..., proj_passes=)")
        if bool(accepted) or bool(underflow):
            return X_out, step, bool(underflow), obj
    raise RuntimeError(
        "line search exceeded max_rounds * trials trials without "
        "acceptance or underflow (stepsize %r)" % float(step))


def nmfsc_phased(V, num_basis_elems: int, config: dict | None = None,
                 **kwargs):
    """nmfsc with host-driven phase-split dispatch (see module docstring).

    Same parameter surface and semantics as models/nmfsc.nmfsc minus
    ``mesh`` (single-device only), plus ``trials`` (line-search trial
    candidates per batched round, default 24), ``proj_passes`` (bounded
    Hoyer projection passes, default 48), and ``fuse_iteration``
    (default True: one dispatch + one readback per outer iteration).
    """
    cfg = merge_config(config, kwargs)
    if cfg.get("mesh") is not None:
        raise ValueError("dispatch='phased' is single-device; drop mesh=")
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = ingest_rescaled(V, dtype)  # nmfsc.m:57-62, device-resident
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, eps, key = common_scalars(cfg)
    w_sp = min(float(cfg.get("W_sparsity", 0.0) or 0.0), 1.0)
    h_sp = min(float(cfg.get("H_sparsity", 0.0) or 0.0), 1.0)
    kw, kh = jax.random.split(key)

    W = cfg.get("W_init")
    if W is None:
        W = jax.random.uniform(kw, (m, k), dtype)  # nmfsc.m:73-75
    W = jnp.asarray(W, dtype)
    H = cfg.get("H_init")
    if H is None:
        H = jax.random.uniform(kh, (k, n), dtype)
        H = H / jnp.sqrt(jnp.sum(H * H, axis=1, keepdims=True))
    H = jnp.asarray(H, dtype)

    l1_w = hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0
    l1_h = hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0
    # empty dict == no resume (a fresh run), checked consistently below
    rs = cfg.get("resume_state") or None
    step_w = jnp.asarray(float(rs["step_w"]) if rs is not None else 1.0,
                         dtype)
    step_h = jnp.asarray(float(rs["step_h"]) if rs is not None else 1.0,
                         dtype)
    # linesearch_width (the fused solvers' parallel-backtracking knob)
    # maps onto this dispatch's batched trial rounds so an EXPLICIT
    # setting composes instead of being silently dropped.  The fused
    # solvers' 'auto' default does NOT apply here: the phased dispatch is
    # round-trip-dominated, so the default stays the bounded sequential
    # trial rounds.
    raw_lw = cfg.get("linesearch_width")
    lw = 0 if raw_lw in (None, "auto") else int(raw_lw)
    spec = _PhSpec(w_sp > 0, h_sp > 0,
                   bool(cfg.get("W_fixed", False)),
                   bool(cfg.get("H_fixed", False)),
                   eps, float(l1_w), float(l1_h),
                   int(cfg.get("trials", lw if lw > 0 else 24)),
                   int(cfg.get("proj_passes", 48)),
                   bool(cfg.get("batched_trials", lw > 0)))
    ph = _build_phases(spec)

    def _initial_projection(X, l1):
        Xp, done = _project_columns_bounded(X, l1, 1.0, spec.proj_passes)
        if not bool(jnp.all(done)):
            raise RuntimeError(
                "bounded Hoyer projection did not converge within "
                "proj_passes passes on the initial factors; raise "
                "nmfsc(..., proj_passes=)")
        return Xp

    if rs is None:
        if w_sp > 0:  # initial projection (nmfsc.m:93-96)
            W = _initial_projection(W, l1_w)
        if h_sp > 0:  # nmfsc.m:106-109
            H = _initial_projection(H.T, l1_h).T

    v_sq = ph["v_sq"](V)
    # Cost bookkeeping stays in the solver dtype (numpy scalars) so the
    # host-side stop rule rounds exactly like the fused on-device one.
    trace = [np.asarray(ph["cost"](V, W, H, v_sq))]  # initial cost (nmfsc.m:137-139)
    n_iters = 0
    terminated = stopped = False
    use_fused = bool(cfg.get("fuse_iteration", True))
    # Speculative block dispatch: enqueue `spec_ahead` fused iterations
    # back-to-back (dispatch is async; device state never leaves the
    # device) and read ALL their flag vectors in ONE stacked readback —
    # the per-iteration host round-trip amortizes to ~1/spec_ahead.
    # Stop-rule hits, underflows, and slow-path fallbacks are processed
    # in order from the fetched flags; any speculated work past such an
    # event is simply discarded (its inputs were device-resident copies,
    # so nothing observable happened).  Trajectory is unaffected.
    spec_ahead = max(1, int(cfg.get("spec_ahead", 4))) if use_fused else 1

    def slow_iteration(W, H, step_w, step_h):
        """One outer iteration via per-phase programs with unbounded
        continuation rounds (also the fallback when a search needs more
        than `trials` halvings).  Returns updated state + cost/None."""
        term = False
        # ---- H phase (nmfsc.m:143-189) ----
        if not spec.h_fixed:
            if spec.h_sparse:
                WtV, WtW = ph["h_grams"](V, W)
                H, step_h, under, _ = _search_to_accept(
                    ph["h_round"], (v_sq, WtV, WtW), H, step_h)
                term |= under
            else:
                W, H = ph["h_mu"](V, W, H)
        # ---- W phase (nmfsc.m:192-233); the reference returns from
        # the H underflow before reaching it (nmfsc.m:170-174) ----
        if not term and not spec.w_fixed:
            if spec.w_sparse:
                VHt, HHt = ph["w_grams"](V, H)
                W, step_w, under, _ = _search_to_accept(
                    ph["w_round"], (v_sq, VHt, HHt), W, step_w)
                term |= under
            else:
                W = ph["w_mu"](V, W, H)
        c = None if term else np.asarray(ph["cost"](V, W, H, v_sq))
        return (W, H, step_w, step_h), term, c

    state = (W, H, step_w, step_h)
    i = 0
    while i < maxiter and not (terminated or stopped):
        if not use_fused:
            n_iters = i + 1
            state, terminated, c = slow_iteration(*state)
            if terminated:
                break  # cost of the terminated iteration is dropped
            trace.append(c)
            tol = np.asarray(tolerance, c.dtype)
            if i >= 1 and c < trace[-2] and trace[-2] - c < tol:
                stopped = True
            i += 1
            continue
        blk = min(spec_ahead, maxiter - i)
        pre, post, outs = [], [], []
        s = state
        for _ in range(blk):
            pre.append(s)
            Wn, Hn, swn, shn, fl = ph["iter"](V, *s, v_sq)
            s = (Wn, Hn, swn, shn)
            post.append(s)
            outs.append(fl)
        flags_all = np.asarray(jnp.stack(outs))  # the ONE sync point
        for b in range(blk):
            fl = flags_all[b]
            h_acc, h_und, h_more, w_acc, w_und, w_more, pok = (
                bool(fl[j]) for j in range(7))
            if not pok:
                raise RuntimeError(
                    "bounded Hoyer projection did not converge within "
                    "proj_passes passes; raise nmfsc(..., proj_passes=)")
            n_iters = i + 1
            if h_more or w_more:
                # a search needs >trials halvings: redo THIS iteration
                # from its entry state via the slow path, then restart
                # speculation (the rest of the block is stale)
                state, terminated, c = slow_iteration(*pre[b])
                i += 1
                if terminated:
                    break
                trace.append(c)
                tol = np.asarray(tolerance, c.dtype)
                if i >= 2 and c < trace[-2] and trace[-2] - c < tol:
                    stopped = True
                break
            state = post[b]
            i += 1
            if h_und or w_und:
                terminated = True  # cost of this iteration is dropped
                break
            c = fl[7]
            trace.append(c)
            tol = np.asarray(tolerance, c.dtype)
            if i >= 2 and c < trace[-2] and trace[-2] - c < tol:
                stopped = True
                break
    W, H, step_w, step_h = state

    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=np.stack(trace),
                  n_iters=n_iters, converged=stopped or terminated,
                  resume_state={"step_w": float(step_w),
                                "step_h": float(step_h)})
