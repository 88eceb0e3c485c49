"""Batched NMF: factorize a stack of matrices in one device program.

Production serving often factorizes MANY small matrices (per-utterance
spectrograms, per-user interaction blocks) rather than one large one.
Dispatching the single-matrix solver per item wastes the chip (each
problem underfills the matmul units and pays a dispatch round trip); here the
euclidean Gram-form MU iteration is ``vmap``-ed over the batch and driven
by one ``lax.scan``, so B problems run as one fused program with batched
(B, m, k)-shaped matmuls.

Fixed iteration count (no per-problem early exit — a converged problem
keeps iterating harmlessly; MU is a fixed point).  Per-problem cost
traces are returned so callers can inspect convergence individually.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (as_list, common_scalars, merge_config,
                    parse_cost_every as _parse_cost_every, per_column,
                    promote_per_source, resolve_dtype, source_blocks,
                    uniform_init, unwrap_sources, Result)
from ..ops import divergence as dv
from ..ops.gram import euclidean_cost_gram, sq_norm
from ..ops.normalize import unit_l2_columns
from ..parallel import (apply_placements, mesh_multiples, pad_amount,
                        pad_axes)


class _Spec(NamedTuple):
    iters: int
    eps: float
    div: str = "euclidean"
    inner: int = 1
    cost_every: int = 1


def _cadence(ce, iters):
    """Dynamic predicate for the iterations whose objective is evaluated
    under ``cost_every=ce``: {1, ce, 2*ce, ...} plus the final one — the
    same cadence as nmf()'s knob (ops/loop.cost_cadence) and the same
    set ``_check_iters`` enumerates statically.  The batched engines run
    a fixed-length scan with no stopping rule, so here the knob affects
    which trace entries are computed vs carried; the skipped evaluations
    drop the objective's (m, n) reconstruction + divergence pass (field
    divergences) or its <WtW H, H> quadratic-form matmul (Gram paths)."""
    def compute(i):
        return ((i + 1) % ce == 0) | (i == 0) | (i + 1 >= iters)
    return compute


# Above ~this many objective evaluations the segmented form would trace
# one update-only lax.scan per check (trace and compile size grow with
# the check count), so dense cadences fall back to the per-step
# lax.cond form, whose relative overhead is small by construction when
# the objective runs nearly every iteration anyway.
_SEGMENT_MAX_CHECKS = 128


def _check_iters(ce, iters):
    """Static (0-indexed) iterations whose objective is computed under
    ``cost_every=ce``: {0} | {ce-1, 2*ce-1, ...} | {iters-1} — the same
    set ``_cadence`` selects dynamically."""
    return sorted({0, iters - 1} | set(range(ce - 1, iters, ce)))


def _segmented_costs(update, eval_cost, state0, ce, iters, cdt):
    """Run ``iters`` update iterations evaluating the objective only at
    the check iterations, with NO per-step lax.cond: the loop is split
    into update-only ``lax.scan`` segments punctuated by one evaluation
    each.  At small per-problem shapes (serving encode) a per-step cond
    can cost more than the (m, n) objective pass it skips, while segments
    make the knob a strict win at every shape.  The update op sequence
    is unchanged, so factors stay bit-identical to cost_every=1.

    ``update(state) -> state`` is one objective-free iteration;
    ``eval_cost(state) -> (B,)`` the objective of the current state.
    Returns ``(state, costs)`` with costs (B, iters); carried entries
    repeat the last computed value (models/nmf.py finish_step
    semantics).
    """
    checks = _check_iters(ce, iters)

    def seg(state, length):
        return jax.lax.scan(lambda st, _: (update(st), None), state,
                            None, length=length)[0]

    state, prev, cols = state0, -1, []
    for c in checks:
        state = seg(state, c - prev)   # includes the check iteration
        cols.append(eval_cost(state).astype(cdt))
        prev = c
    at_checks = jnp.stack(cols, axis=-1)               # (B, n_checks)
    # trace entry i repeats the objective of the latest check <= i
    expand = np.searchsorted(np.asarray(checks), np.arange(iters),
                             side="right") - 1
    return state, at_checks[:, expand]


def _cadenced_encode(upd_b, cost_b, H0, ce, iters, cdt):
    """cost_every > 1 driver shared by every H-only encode engine:
    segmented scan by default, per-step lax.cond fallback when the check
    count would blow up the segmented form's trace size.
    ``upd_b(H) -> H`` one objective-free batched iteration;
    ``cost_b(H) -> (B,)``.  Returns (H, costs (B, iters))."""
    if len(_check_iters(ce, iters)) <= _SEGMENT_MAX_CHECKS:
        return _segmented_costs(upd_b, cost_b, H0, ce, iters, cdt)
    compute = _cadence(ce, iters)
    cp0 = jnp.full((H0.shape[0],), jnp.inf, cdt)

    def body(carry, i):
        H, cp = carry
        Hn = upd_b(H)
        c = jax.lax.cond(compute(i),
                         lambda: cost_b(Hn).astype(cdt),
                         lambda: cp)
        return (Hn, c), c

    (H, _), costs = jax.lax.scan(body, (H0, cp0), jnp.arange(iters))
    return H, costs.T  # (B, iters)


def _make_euclid_step(eps_v, inner=1):
    """Gram-form euclid MU iteration on one (V, W, H) problem — the
    kernel both batched engines vmap (nmf.m:149-186 update structure,
    W-normalization gradient coupling included).  ``inner`` repeats each
    factor update reusing the V-dependent Grams (accelerated MU, Gillis
    & Glineur 2012 — same semantics as nmf(method='gram', inner_iters=),
    trajectories pin against it)."""
    def one_step(V, v_sq, W, H):
        # V may be stored bf16 (data_dtype option): feed the matmul the
        # storage dtype, accumulate in the compute dtype (same pattern
        # as models/nmf.py gram_step vdot).
        cdt = jnp.promote_types(W.dtype, jnp.float32)
        eps = jnp.asarray(eps_v, cdt)

        def vdot(A, B):
            return jax.lax.dot(A, B.astype(A.dtype),
                               preferred_element_type=cdt)

        HHt = H @ H.T
        VHt = vdot(V, H.T)
        for _ in range(inner):
            WG = W @ HHt
            dneg = jnp.sum(W * WG, axis=0)
            dpos = jnp.sum(W * VHt, axis=0)
            W = W * ((VHt + W * dneg[None, :])
                     / jnp.maximum(WG + W * dpos[None, :], eps))
            W = unit_l2_columns(W)
        WtV = vdot(V.T, W).T
        WtW = W.T @ W
        for _ in range(inner):
            H = H * (WtV / jnp.maximum(WtW @ H, eps))
        c = euclidean_cost_gram(v_sq, WtV, WtW, H)
        return W, H, c
    return one_step


def _kl_mask_of(V, valid_m):
    m = V.shape[0]
    if valid_m is not None and valid_m != m:
        return (jnp.arange(m) < valid_m)[:, None]
    return None


def _make_kl_step(eps_v, valid_m=None, with_cost=True):
    """Field-form KL MU iteration on one (V, W, H) problem, matching
    models/nmf.py naive_step (nmf.m:147-199 with phi_pos = ones).
    ``valid_m`` masks the 0/0 ratio fields in mesh-padded rows; the
    ones-field sums are already exact (zero W rows contribute nothing).
    ``with_cost=False`` returns the updated factors only (the
    cost_every > 1 scan evaluates the objective via _make_kl_cost on
    check iterations alone).
    """
    from .nmf import _kl_ones_b, _kl_ones_pos_h

    def one_step(V, v_sq, W, H):
        del v_sq
        eps = jnp.asarray(eps_v, V.dtype)
        m, n = V.shape
        mask = _kl_mask_of(V, valid_m)
        V_hat = W @ H
        phi_neg, _, _ = dv.fields("kl", V, V_hat, mask=mask)
        A = phi_neg @ H.T
        B = _kl_ones_b(H, m)
        dneg = jnp.sum(W * B, axis=0)
        dpos = jnp.sum(W * A, axis=0)
        W = W * ((A + W * dneg[None, :])
                 / jnp.maximum(B + W * dpos[None, :], eps))
        W = unit_l2_columns(W)
        V_hat = W @ H
        phi_neg, _, _ = dv.fields("kl", V, V_hat, mask=mask)
        H = H * ((W.T @ phi_neg)
                 / jnp.maximum(_kl_ones_pos_h(W, n), eps))
        if not with_cost:
            return W, H
        c = dv.cost("kl", V, W @ H, mask=mask)
        return W, H, c
    return one_step


def _make_kl_cost(valid_m=None):
    def one_cost(V, W, H):
        return dv.cost("kl", V, W @ H, mask=_kl_mask_of(V, valid_m))
    return one_cost


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    euclid = spec.div == "euclidean"
    one_step = (_make_euclid_step(spec.eps, spec.inner)
                if euclid else _make_kl_step(spec.eps))
    step_b = jax.vmap(one_step, in_axes=(0, 0, 0, 0))
    ce = int(spec.cost_every)

    if ce == 1:
        @jax.jit
        def solve(Vs, W0, H0):
            v_sq = jax.vmap(sq_norm)(Vs.astype(W0.dtype))  # nmf.py:227

            def body(carry, _):
                W, H = carry
                W, H, c = step_b(Vs, v_sq, W, H)
                return (W, H), c

            (W, H), costs = jax.lax.scan(body, (W0, H0), None,
                                         length=spec.iters)
            return W, H, costs.T  # (B, iters)

        return solve

    compute = _cadence(ce, spec.iters)
    upd_b = (None if euclid else
             jax.vmap(_make_kl_step(spec.eps, with_cost=False),
                      in_axes=(0, 0, 0, 0)))
    cost_b = None if euclid else jax.vmap(_make_kl_cost(),
                                          in_axes=(0, 0, 0))
    use_seg = len(_check_iters(ce, spec.iters)) <= _SEGMENT_MAX_CHECKS

    @jax.jit
    def solve_ce(Vs, W0, H0):
        cdt = jnp.promote_types(W0.dtype, jnp.float32)
        v_sq = jax.vmap(sq_norm)(Vs.astype(W0.dtype))
        cp0 = jnp.full((Vs.shape[0],), jnp.inf, cdt)

        if not euclid and use_seg:
            (W, H), costs = _segmented_costs(
                lambda st: upd_b(Vs, v_sq, *st),
                lambda st: cost_b(Vs, *st),
                (W0, H0), ce, spec.iters, cdt)
            return W, H, costs

        def body(carry, i):
            W, H, cp = carry
            if euclid:
                # the Gram objective is a byproduct of the update —
                # cadence-select the trace, nothing to skip
                W, H, c = step_b(Vs, v_sq, W, H)
                c = jnp.where(compute(i), c.astype(cdt), cp)
            else:
                # dense-cadence fallback (check count past the
                # segmented form's trace-size cap)
                W, H = upd_b(Vs, v_sq, W, H)
                c = jax.lax.cond(
                    compute(i),
                    lambda W=W, H=H: cost_b(Vs, W, H).astype(cdt),
                    lambda: cp)
            return (W, H, c), c

        (W, H, _), costs = jax.lax.scan(body, (W0, H0, cp0),
                                        jnp.arange(spec.iters))
        return W, H, costs.T  # (B, iters)

    return solve_ce


class _SeedSpec(NamedTuple):
    iters: int
    eps: float
    div: str = "euclidean"
    valid_m: int | None = None   # true feature count of a mesh-padded run
    inner: int = 1


@functools.lru_cache(maxsize=None)
def _build_multiseed_solver(spec: _SeedSpec):
    """Like ``_build_solver`` but the data matrix is SHARED across the
    batch: only the inits are vmapped (in_axes V=None), so S restarts of
    the same problem read one copy of V from HBM instead of S copies.
    This is the engine for consensus rank selection (rank.py), where the
    whole point is many random restarts of one matrix.

    Divergences: euclidean (Gram form, V touched twice per iteration)
    and kl (Brunet 2004's original formulation; field form matching
    models/nmf.py naive_step, so per-restart trajectories pin against
    the single solver).  Mesh zero-padding on the feature axis: exact
    for euclidean (zero W rows are absorbing); for KL the padded rows
    produce 0/0 fields and are masked (valid_m), while the ones-field
    sums are already exact (zero W rows contribute nothing).
    """
    one_step = (_make_euclid_step(spec.eps, spec.inner)
                if spec.div == "euclidean"
                else _make_kl_step(spec.eps, spec.valid_m))
    step_s = jax.vmap(one_step, in_axes=(None, None, 0, 0))

    @jax.jit
    def solve(V, W0, H0):
        v_sq = sq_norm(V.astype(W0.dtype))  # nmf.py:227

        def body(carry, _):
            W, H = carry
            W, H, c = step_s(V, v_sq, W, H)
            return (W, H), c

        (W, H), costs = jax.lax.scan(body, (W0, H0), None, length=spec.iters)
        return W, H, costs.T  # (S, iters)

    return solve


def _data_dtype_of(cfg, div, name):
    """Validate data_dtype (bf16 V storage; euclid-only — the KL ratio
    field needs V at compute precision, matching nmf()'s contract)."""
    dd = cfg.get("data_dtype")
    if dd is None:
        return None
    if div != "euclidean":
        raise ValueError(f"{name}: data_dtype is only supported with "
                         "the euclidean divergence")
    return jnp.dtype(dd)


def _encode_weights_of(cfg, B, m, n, mesh, solver, name, dtype):
    """Validate + place the encode engines' optional per-entry weights:
    (m, n) shared across the batch or (B, m, n) per problem; nonnegative
    and NaN-free (weight 0 = missing entry).  Returns (weights, mode)
    with mode in (None, 'shared', 'batched')."""
    Mw = cfg.get("weights")
    if Mw is None:
        return None, None
    Mw = jnp.asarray(Mw, dtype)
    if Mw.shape == (m, n):
        mode = "shared"
    elif Mw.shape == (B, m, n):
        mode = "batched"
    else:
        raise ValueError(
            f"{name}: weights must be (m, n) = {(m, n)} shared across the "
            f"batch or (B, m, n) = {(B, m, n)} per problem; got {Mw.shape}")
    if bool(jnp.any(Mw < 0) | jnp.any(jnp.isnan(Mw))):
        raise ValueError(
            "weights must be nonnegative and NaN-free; to down-weight or "
            "drop an entry use weight 0 (padding.prepare_weights contract)")
    if mesh is not None:
        from ..parallel import replicate
        # batched weights shard like V (problems over the sample axis);
        # shared weights replicate like the dictionary.
        Mw = (apply_placements(mesh, solver, V=Mw) if mode == "batched"
              else jax.device_put(Mw, replicate(mesh)))
    return Mw, mode


def _check_batch_mesh(B, mesh, name):
    """Friendly divisibility error (mirrors nmf_multiseed's S check)."""
    if mesh is None:
        return
    _, nmul = mesh_multiples(mesh)
    if B % nmul:
        raise ValueError(
            f"{name}: batch size B={B} must be a multiple of the mesh's "
            f"sample axis ({nmul}): problems shard over it. Pad the batch "
            "or use a smaller mesh.")


def _reject_encode_config(cfg, name):
    """The encode engines fit H only, for a fixed iteration count; error
    rather than silently ignore options that cannot apply (the CLI's
    convention)."""
    msgs = {
        "W_fixed": "the dictionary W is the positional argument and is "
                   "always fixed",
        "W_init": "the dictionary W is the positional argument and is "
                  "always fixed",
        "W_sparsity": "the dictionary W is the positional argument and is "
                      "always fixed",
        "H_fixed": "encoding fits H — with H also fixed there is nothing "
                   "to solve",
        "inner_iters": "accelerated MU repeats the W phase, which encode "
                       "does not run",
    }
    for key, why in msgs.items():
        if cfg.get(key) is not None:
            raise ValueError(f"{name}: {key!r} does not apply — {why}")


def _inner_of(cfg, div, name):
    """Validate inner_iters (accelerated MU is euclid-Gram-only,
    matching nmf()'s contract)."""
    inner = int(cfg.get("inner_iters", 1) or 1)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    if inner > 1 and div != "euclidean":
        raise ValueError(
            f"{name}: inner_iters > 1 (accelerated MU) requires the "
            "euclidean divergence")
    return inner


def nmf_multiseed(V, num_basis_elems: int, n_seeds: int,
                  config: dict | None = None, **kwargs):
    """NMF of ONE matrix from ``n_seeds`` random restarts.

    All restarts run as a single fused program (vmap over the inits,
    V shared), so the chip cost is one batched solve, not S dispatches.
    Parameters: divergence ('euclidean' | 'kl' — Brunet 2004's consensus
    method is classically KL), maxiter (100), inner_iters (accelerated
    MU, euclid only), seed, dtype, eps,
    W_init/H_init with a leading (S,) axis, mesh (restarts shard over
    the sample axis — S must be a multiple of that axis' size; V shards
    over the feature axis), device_output (True keeps W/H as jax
    arrays — no host fetch, for downstream device pipelines).  Returns
    Result with W (S, m, k), H (S, k, n), cost (S, maxiter).
    """
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div not in ("euclidean", "kl"):
        raise ValueError(
            f"nmf_multiseed supports divergence 'euclidean' or 'kl'; got "
            f"{cfg.get('divergence')!r} (use the single-matrix nmf() for "
            "the IS/AB families)")
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    if V.ndim != 2:
        raise ValueError(f"nmf_multiseed expects (m, n); got {V.shape}")
    m, n = V.shape
    k = int(num_basis_elems)
    S = int(n_seeds)
    if S < 1:
        raise ValueError(f"n_seeds must be >= 1; got {n_seeds}")
    maxiter, _, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(kw, (S, m, k), dtype)
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(kh, (S, k, n), dtype)
    W0 = jnp.asarray(W0, dtype)
    H0 = jnp.asarray(H0, dtype)
    if W0.shape != (S, m, k) or H0.shape != (S, k, n):
        raise ValueError(
            f"inits must carry a leading seed axis: W_init {(S, m, k)}, "
            f"H_init {(S, k, n)}; got {W0.shape}, {H0.shape}")
    W0 = jax.vmap(unit_l2_columns)(W0)  # nmf.m:132-134

    # mesh: restarts shard over the sample axis (data-parallel), the
    # shared V over the feature axis (see parallel/mesh.py table).
    # Zero-padding the feature axis is EXACT for the euclid MU update:
    # zero rows of W stay zero (multiplicative), contribute nothing to
    # the Grams / column norms / cost, and are sliced off on return.
    mesh = cfg.get("mesh")
    pad_m = 0
    if mesh is not None:
        mmul, nmul = mesh_multiples(mesh)
        if S % nmul:
            raise ValueError(
                f"n_seeds={S} must be a multiple of the mesh's sample "
                f"axis ({nmul}): restarts shard over it. Round n_seeds "
                f"up or use a smaller mesh.")
        pad_m = pad_amount(m, mmul)
        if pad_m:
            V = pad_axes(V, {0: pad_m})
            W0 = pad_axes(W0, {1: pad_m})
    dd = _data_dtype_of(cfg, div, "nmf_multiseed")
    if dd is not None:
        V = V.astype(dd)  # storage dtype; factors stay at compute dtype
    V, W0, H0 = apply_placements(mesh, "nmf_multiseed", V=V, W=W0, H=H0)

    spec = _SeedSpec(maxiter, eps, div, m if pad_m else None,
                     _inner_of(cfg, div, 'nmf_multiseed'))
    W, H, costs = _build_multiseed_solver(spec)(V, W0, H0)
    if pad_m:
        W = W[:, :m, :]
    if cfg.get("device_output"):
        # Serving option: skip the host fetch (the factors stay jax
        # arrays for downstream device pipelines).
        return Result(fields=("W", "H", "cost"), W=W, H=H,
                      cost=np.asarray(costs), n_iters=maxiter,
                      converged=False)
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H), cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)


class _EncSpec(NamedTuple):
    iters: int
    eps: float
    div: str = "euclidean"
    alpha: float = 1.0
    beta: float = 1.0
    weighted: str | None = None   # None | 'shared' (m, n) | 'batched' (B, m, n)
    cost_every: int = 1


@functools.lru_cache(maxsize=None)
def _build_encode_solver(spec: _EncSpec):
    """H-only MU against ONE shared dictionary W — the serving decode
    path (train W once with nmf(), then encode each incoming matrix).

    Trajectories pin against nmf(..., W_init=W, W_fixed=True) per
    problem (tests/test_batched.py): the single solver with W fixed
    skips the W branch, so its per-iteration H update reads only
    loop-invariant W-products — which this engine hoists out of the
    scan.  Euclidean runs entirely in Gram space after a one-time
    W'V per problem (iterations never touch V); the field divergences
    (kl/is/ab incl. the alpha=0 dual) re-read V for the ratio fields
    each iteration (nmf.m:176-199) but hoist what is loop-invariant
    (KL's ones-field denominator W'1, nmf.m:184).
    """
    euclid = spec.div == "euclidean"
    a, b = spec.alpha, spec.beta
    ce = int(spec.cost_every)

    if spec.weighted is not None:
        # Per-entry weighted objective: every divergence goes through the
        # field form with both fields weight-scaled (ops/divergence.py),
        # exactly like nmf(weights=) under W_fixed (which forces
        # method='naive' for euclid too — the Gram hoist is invalid since
        # the weighted positive field moves with V_hat each iteration).
        mw_axis = 0 if spec.weighted == "batched" else None

        @jax.jit
        def solve_w(Vs, W, H0, hsp, Mw):
            cdt = jnp.promote_types(W.dtype, jnp.float32)
            eps = jnp.asarray(spec.eps, cdt)

            def one_update(V, Mwi, H):
                V_hat = W @ H
                phi_neg, phi_pos, power = dv.fields(spec.div, V, V_hat,
                                                    a, b, weights=Mwi)
                neg = dv.apply_power(W.T @ phi_neg, power)
                pos = dv.apply_power(W.T @ phi_pos, power)
                return H * (neg / jnp.maximum(pos + hsp[:, None], eps))

            def one_cost(V, Mwi, Hn):
                c = dv.cost(spec.div, V, W @ Hn, a, b, weights=Mwi)
                return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

            def one_step(V, Mwi, H):
                Hn = one_update(V, Mwi, H)
                return Hn, one_cost(V, Mwi, Hn)

            if ce == 1:
                step_b = jax.vmap(one_step, in_axes=(0, mw_axis, 0))

                def body(H, _):
                    H, c = step_b(Vs, Mw, H)
                    return H, c

                H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
                return H, costs.T  # (B, iters)

            # cost_every > 1: the weighted fields re-read V and Mw for the
            # objective; skip both on non-check iterations
            upd_b = jax.vmap(one_update, in_axes=(0, mw_axis, 0))
            cost_b = jax.vmap(one_cost, in_axes=(0, mw_axis, 0))
            return _cadenced_encode(lambda H: upd_b(Vs, Mw, H),
                                    lambda H: cost_b(Vs, Mw, H),
                                    H0, ce, spec.iters, cdt)

        return solve_w

    @jax.jit
    def solve(Vs, W, H0, hsp):
        cdt = jnp.promote_types(W.dtype, jnp.float32)
        eps = jnp.asarray(spec.eps, cdt)

        def vdot(A, B):
            # V may be stored bf16 (data_dtype, euclid only): feed the
            # matmul the storage dtype, accumulate in the compute dtype.
            return jax.lax.dot(A, B.astype(A.dtype),
                               preferred_element_type=cdt)

        if euclid:
            v_sq = jax.vmap(sq_norm)(Vs.astype(W.dtype))   # nmf.py:227
            # One-time V-touching work; the scan below is V-free.
            WtV = jax.vmap(lambda V: vdot(V.T, W).T)(Vs)   # (B, k, n)
            WtW = W.T @ W

            def one_update(wtv, H):
                return H * (wtv / jnp.maximum(WtW @ H + hsp[:, None], eps))

            def one_cost(wtv, vsq, Hn):
                c = euclidean_cost_gram(vsq, wtv, WtW, Hn)
                return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

            if ce == 1:
                def one_step(wtv, vsq, H):
                    Hn = one_update(wtv, H)
                    return Hn, one_cost(wtv, vsq, Hn)

                step_b = jax.vmap(one_step, in_axes=(0, 0, 0))

                def body(H, _):
                    H, c = step_b(WtV, v_sq, H)
                    return H, c

                H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
                return H, costs.T  # (B, iters)

            # cost_every > 1: even in Gram space the objective is not
            # free — its quadratic form <WtW @ Hn, Hn> is one extra
            # (k, k) x (k, n) matmul per problem, comparable to the
            # update itself; the skipped iterations drop it
            upd_b = jax.vmap(one_update, in_axes=(0, 0))
            cost_b = jax.vmap(one_cost, in_axes=(0, 0, 0))
            return _cadenced_encode(lambda H: upd_b(WtV, H),
                                    lambda H: cost_b(WtV, v_sq, H),
                                    H0, ce, spec.iters, cdt)

        # General field divergence (kl/is/ab + dual), mirroring the
        # single solver's naive_step with w_any=False.
        from .nmf import _kl_ones_pos_h
        n = Vs.shape[-1]
        # KL's phi_pos is None (the implicit ones field): its H
        # denominator W'1 is loop-invariant — hoist it.
        kl_pos = _kl_ones_pos_h(W, n)

        def one_update(V, H):
            V_hat = W @ H
            phi_neg, phi_pos, power = dv.fields(spec.div, V, V_hat,
                                                a, b)
            neg = dv.apply_power(W.T @ phi_neg, power)
            pos = kl_pos if phi_pos is None else W.T @ phi_pos
            pos = dv.apply_power(pos, power)
            return H * (neg / jnp.maximum(pos + hsp[:, None], eps))

        def one_cost(V, Hn):
            c = dv.cost(spec.div, V, W @ Hn, a, b)
            return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

        def one_step(V, H):
            Hn = one_update(V, H)
            return Hn, one_cost(V, Hn)

        if ce == 1:
            step_b = jax.vmap(one_step, in_axes=(0, 0))

            def body(H, _):
                H, c = step_b(Vs, H)
                return H, c

            H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
            return H, costs.T  # (B, iters)

        # cost_every > 1: the objective's reconstruction + divergence
        # field drop out of the skipped iterations entirely — for KL
        # encode that is nearly half the per-iteration flops
        upd_b = jax.vmap(one_update, in_axes=(0, 0))
        cost_b = jax.vmap(one_cost, in_axes=(0, 0))
        return _cadenced_encode(lambda H: upd_b(Vs, H),
                                lambda H: cost_b(Vs, H),
                                H0, ce, spec.iters, cdt)

    return solve


def nmf_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen dictionary W (m, k).

    The deployment half of the serving pipeline: ``nmf()`` trains the
    dictionary once; this runs the H-only multiplicative updates for all
    B incoming matrices as a single fused device program (one dispatch,
    batched (B, k, n) matmuls).  Per-problem trajectories are exactly
    ``nmf(V_i, k, W_init=W, W_fixed=True)`` — the reference semantics of
    a fixed basis (nmf.m:51-60 W_fixed switch) — including the entry
    unit-L2 column normalization of W (nmf.m:132-134; a dictionary
    trained by nmf() is already normalized, so this is the identity for
    the intended flow).

    Euclidean iterations never touch V: after a one-time W'V per
    problem, each step is a (k, k) x (k, n) Gram-space update — the
    per-iteration cost is independent of the feature count m.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' — the full
    nmf() family, incl. the alpha=0 AB dual), alpha/beta (AB),
    H_init (B, k, n),
    H_sparsity (scalar-or-per-source L1 penalty on H — sparse coding
    against the dictionary, nmf.m:216-218 cost term), maxiter (100),
    seed, dtype, eps, data_dtype (bf16 V storage, euclid only), mesh
    (problems shard over the batch axis), device_output (True keeps H on
    device), cost_every (int, default 1: evaluate the objective trace
    every N iterations, carrying the last value in between — the H
    trajectory is bit-identical, and for the field divergences the
    skipped evaluations drop the objective's (m, n) reconstruction +
    divergence pass, nearly halving KL-encode per-iteration work).
    W may be a LIST of per-source dictionaries (cell-array
    semantics, nmf.m:114-116): they concatenate along the basis axis and
    W/H return as per-source lists — the shape separate() consumes.
    Returns Result with W (m, k, the normalized dictionary), H (B, k, n),
    cost (B, maxiter).
    """
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha = float(cfg.get("alpha", 1.0))
    beta = float(cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    _reject_encode_config(cfg, "nmf_encode")
    dtype = resolve_dtype(Vs, cfg.get("dtype"))
    Vs = jnp.asarray(Vs, dtype)
    if Vs.ndim != 3:
        raise ValueError(f"nmf_encode expects Vs of shape (B, m, n); got "
                         f"{Vs.shape} (encode a single matrix with "
                         "nmf(V, k, W_init=W, W_fixed=True))")
    B, m, n = Vs.shape
    _check_batch_mesh(B, cfg.get("mesh"), "nmf_encode")
    # Multi-source dictionary (MATLAB cell-array semantics, nmf.m:114-116):
    # a list of per-source dictionaries concatenates along the basis axis
    # and H unwraps to per-source blocks on return — the shape separate()
    # consumes directly.
    w_list, w_was_seq = as_list(W)
    w_list = [jnp.asarray(w, dtype) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 2 or w.shape[0] != m:
            raise ValueError(f"dictionary W[{s}] must be (m, k) = ({m}, k); "
                             f"got {w.shape}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = jnp.concatenate(w_list, axis=1)
    k = W.shape[1]
    W = unit_l2_columns(W)  # nmf.m:132-134 (identity for trained dicts)
    maxiter, _, eps, key = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(key, (B, k, n), dtype)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = jnp.concatenate([jnp.asarray(h, dtype) for h in H0], axis=1)
    H0 = jnp.asarray(H0, dtype)
    if H0.shape != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {H0.shape}")
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, dtype)

    dd = _data_dtype_of(cfg, div, "nmf_encode")
    if dd is not None:
        if cfg.get("weights") is not None:
            raise ValueError("nmf_encode: data_dtype is not supported with "
                             "weights= (the weighted fields read V at "
                             "compute precision, matching nmf()'s contract)")
        Vs = Vs.astype(dd)  # storage dtype; factors stay at compute dtype

    # mesh: problems shard over the batch axis; the dictionary and its
    # (k, k) Gram are replicated (k is small).
    mesh = cfg.get("mesh")
    Vs, W, H0 = apply_placements(mesh, "nmf_encode", V=Vs, W=W, H=H0)
    Mw, mw_mode = _encode_weights_of(cfg, B, m, n, mesh, "nmf_encode",
                                     "nmf_encode", dtype)

    spec = _EncSpec(maxiter, eps, div, alpha, beta, mw_mode,
                    _parse_cost_every(cfg))
    if Mw is None:
        H, costs = _build_encode_solver(spec)(Vs, W, H0, hsp)
    else:
        H, costs = _build_encode_solver(spec)(Vs, W, H0, hsp, Mw)
    if cfg.get("device_output"):
        # Serving option: factors stay jax arrays (no host round trip);
        # multi-source unwrap slices without fetching.
        Wo = ([W[:, a:b] for a, b in blocks] if w_was_seq else W)
        Ho = ([H[:, a:b] for a, b in blocks] if w_was_seq else H)
        return Result(fields=("W", "H", "cost"), W=Wo, H=Ho,
                      cost=np.asarray(costs), n_iters=maxiter,
                      converged=False)
    return Result(fields=("W", "H", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 1, w_was_seq),
                  cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)


class _ConvEncSpec(NamedTuple):
    iters: int
    eps: float
    div: str
    T: int
    alpha: float = 1.0
    beta: float = 1.0
    weighted: str | None = None   # None | 'shared' | 'batched'
    cost_every: int = 1


@functools.lru_cache(maxsize=None)
def _build_conv_encode_solver(spec: _ConvEncSpec):
    """H-only convolutive MU against one shared (m, k, T) dictionary.

    Trajectories pin against cnmf(..., W_init=W, W_fixed=True) per
    problem: euclidean follows the Gram path (cnmf.py gram_step with
    w_any=False — the V-touching gneg = conv_wt_phi(W, V) is
    loop-invariant and hoisted, so iterations run in (T, T, k, k) Gram
    space); KL follows the naive kl_fast path including the reference's
    no-shift ones-field quirk (cnmf.m:220-224), with the loop-invariant
    positive field sum(W) hoisted.
    """
    from ..ops.gram import conv_cross_grams_h, conv_cross_grams_w
    from ..ops.shift import (conv_reconstruct, conv_wt_phi, shift_left,
                             stack_shifts_right)
    T = spec.T
    a, b = spec.alpha, spec.beta
    weighted = spec.weighted is not None
    euclid = spec.div == "euclidean" and a == 1.0 and b == 1.0 and not weighted
    dual = a == 0.0
    power = (1.0 / b) if dual else (None if a == 1.0 else 1.0 / a)
    # The KL ones-field shortcut (and the reference's no-shift quirk it
    # encodes, cnmf.m:220-224) is a property of the position-independent
    # ones field only: with weights the positive field is the weight
    # matrix and must be treated like any other field (cnmf.py step).
    kl_fast = spec.div == "kl" and not weighted

    ce = int(spec.cost_every)

    if weighted:
        mw_axis = 0 if spec.weighted == "batched" else None

        @jax.jit
        def solve_w(Vs, W, H0, hsp, Mw):
            dt = W.dtype
            eps = jnp.asarray(spec.eps, dt)
            cdt = jnp.promote_types(dt, jnp.float32)

            def one_update(V, Mwi, H):
                V_hat = conv_reconstruct(W, H, None)
                phi_neg, phi_pos, _ = dv.ab_fields(V, V_hat, a, b,
                                                   weights=Mwi)
                gneg = dv.apply_power(conv_wt_phi(W, phi_neg), power)
                gpos = dv.apply_power(conv_wt_phi(W, phi_pos), power)
                return H * (gneg / jnp.maximum(gpos + hsp[:, None], eps))

            def one_cost(V, Mwi, Hn):
                c = dv.cost(spec.div, V, conv_reconstruct(W, Hn, None),
                            a, b, weights=Mwi)
                return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

            if ce > 1:
                upd_b = jax.vmap(one_update, in_axes=(0, mw_axis, 0))
                cost_b = jax.vmap(one_cost, in_axes=(0, mw_axis, 0))
                return _cadenced_encode(lambda H: upd_b(Vs, Mw, H),
                                        lambda H: cost_b(Vs, Mw, H),
                                        H0, ce, spec.iters, cdt)

            def one_step(V, Mwi, H):
                Hn = one_update(V, Mwi, H)
                return Hn, one_cost(V, Mwi, Hn)

            step_b = jax.vmap(one_step, in_axes=(0, mw_axis, 0))

            def body(H, _):
                H, c = step_b(Vs, Mw, H)
                return H, c

            H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
            return H, costs.T  # (B, iters)

        return solve_w

    @jax.jit
    def solve(Vs, W, H0, hsp):
        dt = W.dtype
        eps = jnp.asarray(spec.eps, dt)
        cdt = jnp.promote_types(dt, jnp.float32)
        WW = conv_cross_grams_w(W)  # (T, T, k, k), loop-invariant

        if euclid:
            v_sqs = jax.vmap(sq_norm)(Vs)
            Gneg = jax.vmap(lambda V: conv_wt_phi(W, V))(Vs)  # one-time

            def one_update(gneg, H):
                Hs = stack_shifts_right(H, T)
                gpos = jnp.zeros_like(gneg)
                for t in range(T):
                    gpos = gpos + shift_left(
                        jnp.einsum("skl,sln->kn", WW[t], Hs,
                                   preferred_element_type=dt), t)
                return H * (gneg / jnp.maximum(gpos + hsp[:, None], eps))

            def one_cost(gneg, vsq, Hn):
                # the cross-Gram HH is the objective's OWN (T, T, k, k)
                # recomputation — skipped under cost_every > 1
                HH = conv_cross_grams_h(stack_shifts_right(Hn, T))
                c = jnp.maximum(
                    0.5 * (vsq - 2.0 * jnp.sum(gneg * Hn)
                           + jnp.sum(WW * HH)), 0.0)
                return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

            if ce > 1:
                upd_b = jax.vmap(one_update, in_axes=(0, 0))
                cost_b = jax.vmap(one_cost, in_axes=(0, 0, 0))
                return _cadenced_encode(lambda H: upd_b(Gneg, H),
                                        lambda H: cost_b(Gneg, v_sqs, H),
                                        H0, ce, spec.iters, cdt)

            def one_step(gneg, vsq, H):
                Hn = one_update(gneg, H)
                return Hn, one_cost(gneg, vsq, Hn)

            step_b = jax.vmap(one_step, in_axes=(0, 0, 0))

            def body(H, _):
                H, c = step_b(Gneg, v_sqs, H)
                return H, c
        else:
            # General AB field step mirroring cnmf.py's naive step with
            # w_any=False.  KL's ones-field denominator (sum_t W_t' @
            # ones = broadcast of sum(W), incl. the reference's no-shift
            # quirk cnmf.m:220-224) is loop-invariant — hoist it.
            w_sum = jnp.sum(W, axis=(0, 2))  # (k,)

            def one_update(V, H):
                V_hat = conv_reconstruct(W, H, None)
                phi_neg, phi_pos, _ = dv.ab_fields(V, V_hat, a, b)
                gneg = conv_wt_phi(W, phi_neg)
                if kl_fast:
                    gpos = jnp.broadcast_to(w_sum[:, None], gneg.shape)
                else:
                    gpos = conv_wt_phi(W, phi_pos)
                gneg = dv.apply_power(gneg, power)
                gpos = dv.apply_power(gpos, power)
                return H * (gneg / jnp.maximum(gpos + hsp[:, None], eps))

            def one_cost(V, Hn):
                # the objective's own T-shift reconstruction — the
                # expensive half of a convolutive encode iteration,
                # skipped under cost_every > 1
                c = dv.cost(spec.div, V, conv_reconstruct(W, Hn, None),
                            a, b)
                return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=1))

            if ce > 1:
                upd_b = jax.vmap(one_update, in_axes=(0, 0))
                cost_b = jax.vmap(one_cost, in_axes=(0, 0))
                return _cadenced_encode(lambda H: upd_b(Vs, H),
                                        lambda H: cost_b(Vs, H),
                                        H0, ce, spec.iters, cdt)

            def one_step(V, H):
                Hn = one_update(V, H)
                return Hn, one_cost(V, Hn)

            step_b = jax.vmap(one_step, in_axes=(0, 0))

            def body(H, _):
                H, c = step_b(Vs, H)
                return H, c

        H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
        return H, costs.T  # (B, iters)

    return solve


def cnmf_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen CONVOLUTIVE
    dictionary W (m, k, T) — the serving decode path for convolutive
    audio dictionaries (cnmf trains W once; each incoming spectrogram
    only fits its encoding).

    Per-problem trajectories are exactly
    ``cnmf(V_i, k, T, W_init=W, W_fixed=True)``, including the entry
    cross-frame normalization of W (cnmf.m:157-166; its column norms are
    transferred into the H inits, an identity for dictionaries trained
    by cnmf()) and, for KL, the reference's no-shift ones-field quirk
    (cnmf.m:220-224).  Euclidean iterations never touch V: after a
    one-time conv_wt_phi(W, V) per problem, each step runs in
    (T, T, k, k) Gram space.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' — cnmf's
    full AB family, cnmf.m:137-147), alpha/beta (AB), H_init (B, k, n),
    H_sparsity (scalar-or-per-source), maxiter (100), seed, dtype, eps,
    mesh (problems shard over the batch axis), device_output,
    cost_every (int, default 1: objective trace every N iterations — H
    trajectory bit-identical; skipped evaluations drop the objective's
    own T-shift reconstruction + divergence pass for the field
    divergences, or its (T, T, k, k) cross-Gram for euclidean).  W may
    be a LIST of per-source dictionaries sharing one T (cell-array
    semantics); W/H return as per-source lists.  Returns Result with
    W (m, k, T, normalized), H (B, k, n), cost (B, maxiter).
    """
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0),
                               cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    _reject_encode_config(cfg, "cnmf_encode")
    if cfg.get("data_dtype") is not None:
        raise ValueError("cnmf_encode: data_dtype is not supported — the "
                         "one-time conv_wt_phi and the field paths read V "
                         "at compute precision")
    dtype = resolve_dtype(Vs, cfg.get("dtype"))
    Vs = jnp.asarray(Vs, dtype)
    if Vs.ndim != 3:
        raise ValueError(f"cnmf_encode expects Vs of shape (B, m, n); got "
                         f"{Vs.shape} (encode a single matrix with "
                         "cnmf(V, k, T, W_init=W, W_fixed=True))")
    B, m, n = Vs.shape
    _check_batch_mesh(B, cfg.get("mesh"), "cnmf_encode")
    # Multi-source convolutive dictionary: list concatenates along the
    # basis axis (all sources share T), H unwraps per source on return.
    w_list, w_was_seq = as_list(W)
    w_list = [jnp.asarray(w, dtype) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 3 or w.shape[0] != m:
            raise ValueError(f"convolutive dictionary W[{s}] must be "
                             f"(m, k, T) with m = {m}; got {w.shape}")
        if w.shape[2] != w_list[0].shape[2]:
            raise ValueError("all source dictionaries must share the same "
                             f"context length; got T={w.shape[2]} vs "
                             f"{w_list[0].shape[2]}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = jnp.concatenate(w_list, axis=1)
    k, T = W.shape[1], W.shape[2]
    maxiter, _, eps, key = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(key, (B, k, n), dtype)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = jnp.concatenate([jnp.asarray(h, dtype) for h in H0], axis=1)
    H0 = jnp.asarray(H0, dtype)
    if H0.shape != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {H0.shape}")
    # Entry cross-frame normalization with norm transfer into every
    # problem's H init (cnmf.m:157-166; cnmf.py applies this
    # unconditionally, W_fixed included — identity for trained dicts).
    from ..ops.normalize import cross_frame_norm
    W, H0 = cross_frame_norm(W, H0, T)
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, dtype)

    mesh = cfg.get("mesh")
    Vs, W, H0 = apply_placements(mesh, "cnmf_encode", V=Vs, W=W, H=H0)
    Mw, mw_mode = _encode_weights_of(cfg, B, m, n, mesh, "cnmf_encode",
                                     "cnmf_encode", dtype)

    spec = _ConvEncSpec(maxiter, eps, div, T, alpha, beta, mw_mode,
                        _parse_cost_every(cfg))
    if Mw is None:
        H, costs = _build_conv_encode_solver(spec)(Vs, W, H0, hsp)
    else:
        H, costs = _build_conv_encode_solver(spec)(Vs, W, H0, hsp, Mw)
    if cfg.get("device_output"):
        Wo = ([W[:, a:b] for a, b in blocks] if w_was_seq else W)
        Ho = ([H[:, a:b] for a, b in blocks] if w_was_seq else H)
        return Result(fields=("W", "H", "cost"), W=Wo, H=Ho,
                      cost=np.asarray(costs), n_iters=maxiter,
                      converged=False)
    return Result(fields=("W", "H", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 1, w_was_seq),
                  cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)


def nmf_batched(Vs, num_basis_elems: int, config: dict | None = None,
                **kwargs):
    """NMF over a batch Vs of shape (B, m, n).

    Parameters: divergence ('euclidean' | 'kl' — KL is the spectrogram
    serving objective), W_init (B, m, k), H_init (B, k, n), maxiter
    (100), inner_iters (accelerated MU, euclid only), seed, dtype, eps,
    mesh (problems shard over the batch axis — B must divide the mesh
    size), device_output (True keeps W/H as jax arrays — no host
    fetch), cost_every (int, default 1: evaluate the objective trace
    every N iterations, carrying the last value in between — the factor
    trajectory is bit-identical; for KL the skipped evaluations drop the
    objective's (m, n) reconstruction + log pass).
    Returns Result with W (B, m, k),
    H (B, k, n), and cost (B, maxiter) — one trace per problem.
    """
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div not in ("euclidean", "kl"):
        raise ValueError(
            f"nmf_batched supports divergence 'euclidean' or 'kl'; got "
            f"{cfg.get('divergence')!r} (use the single-matrix nmf() for "
            "the IS/AB families)")
    dtype = resolve_dtype(Vs, cfg.get("dtype"))
    Vs = jnp.asarray(Vs, dtype)
    if Vs.ndim != 3:
        raise ValueError(f"nmf_batched expects (B, m, n); got {Vs.shape}")
    B, m, n = Vs.shape
    _check_batch_mesh(B, cfg.get("mesh"), "nmf_batched")
    k = int(num_basis_elems)
    maxiter, _, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(kw, (B, m, k), dtype)
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(kh, (B, k, n), dtype)
    W0 = jax.vmap(unit_l2_columns)(jnp.asarray(W0, dtype))  # nmf.m:132-134
    H0 = jnp.asarray(H0, dtype)

    dd = _data_dtype_of(cfg, div, "nmf_batched")
    if dd is not None:
        Vs = Vs.astype(dd)  # storage dtype; factors stay at compute dtype

    # mesh: problems shard over the batch axis (data-parallel serving)
    Vs, W0, H0 = apply_placements(cfg.get("mesh"), "nmf_batched",
                                  V=Vs, W=W0, H=H0)

    spec = _Spec(maxiter, eps, div, _inner_of(cfg, div, 'nmf_batched'),
                 _parse_cost_every(cfg))
    W, H, costs = _build_solver(spec)(Vs, W0, H0)
    if cfg.get("device_output"):
        # Serving option: factors stay jax arrays (no host round trip).
        return Result(fields=("W", "H", "cost"), W=W, H=H,
                      cost=np.asarray(costs), n_iters=maxiter,
                      converged=False)
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H), cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)


class _CmfEncSpec(NamedTuple):
    iters: int
    eps: float
    blocks: tuple
    p_fixed: tuple


@functools.lru_cache(maxsize=None)
def _build_cmf_encode_solver(spec: _CmfEncSpec):
    """H/P-only complex MU against one shared real dictionary W — the
    phase-aware serving decode (cmfwisa trains the magnitude
    dictionaries once; each incoming complex spectrogram fits its
    encodings and per-source phases).

    Trajectories pin against cmfwisa(V_i, ks, W_init=[W_s],
    W_fixed=True) per problem (tests/test_batched.py): with W frozen the
    H denominator's (W_new' W_stale) H collapses to (W'W) H with a
    loop-invariant (k, k) Gram — hoisted out of the scan.  The
    per-iteration V_bar/beta/G fields (cmfwisa.m:177-188) are nonlinear
    in H and stay in the loop.  Complex data and phases cross the jit
    boundary as real planes (the models/cmfwisa.py convention); all
    complex arithmetic lives inside the one compiled program.
    """
    blocks = spec.blocks
    S = len(blocks)

    @jax.jit
    def solve(V_re, V_im, W, H0, P_re, P_im, hsp):
        rdt = W.dtype
        eps = jnp.asarray(spec.eps, rdt)
        Vs = jax.lax.complex(V_re, V_im)       # (B, m, n)
        P0 = jax.lax.complex(P_re, P_im)       # (B, S, m, n)
        WtW = W.T @ W                          # loop-invariant (k, k)

        def per_source_wh(H):
            return jnp.stack([W[:, a:b] @ H[a:b, :] for a, b in blocks])

        def one_step(V, H, P, WH):
            # WH = per_source_wh(H) rides the scan carry (the single
            # solver's pattern, models/cmfwisa.py): XLA cannot CSE
            # across scan iterations, so recomputing it at step entry
            # would pay the full (S, m, k)x(k, n) stack twice per
            # iteration.
            V_hat = jnp.sum(WH * P, axis=0)
            R = jnp.sum(WH, axis=0)            # stale W_all H_all
            beta = WH / R                      # cmfwisa.m:178
            V_bar = WH * P + beta * (V - V_hat)
            P_new = jnp.exp(1j * jnp.angle(V_bar)).astype(P.dtype)
            if any(spec.p_fixed):
                P_new = jnp.stack([P[s] if spec.p_fixed[s] else P_new[s]
                                   for s in range(S)])
            G = jnp.abs(V_bar) / beta          # (S, m, n) real
            M = WtW @ H                        # cmfwisa.m:200 with W fixed
            rows = [H[a:b] * ((W[:, a:b].T @ G[s])
                              / jnp.maximum(M[a:b] + hsp[a:b, None], eps))
                    for s, (a, b) in enumerate(blocks)]
            Hn = jnp.concatenate(rows, axis=0)
            WH_new = per_source_wh(Hn)
            diff = V - jnp.sum(WH_new * P_new, axis=0)
            c = jnp.sum(jnp.real(diff * jnp.conj(diff)))
            c = c + jnp.sum(hsp * jnp.sum(Hn, axis=1))
            return Hn, P_new, WH_new, c

        step_b = jax.vmap(one_step, in_axes=(0, 0, 0, 0))

        def body(carry, _):
            H, P, WH = carry
            H, P, WH, c = step_b(Vs, H, P, WH)
            return (H, P, WH), c

        WH0 = jax.vmap(per_source_wh)(H0)
        (H, P, _), costs = jax.lax.scan(body, (H0, P0, WH0), None,
                                        length=spec.iters)
        # complex -> real planes for the transfer back
        return H, jnp.real(P), jnp.imag(P), costs.T  # costs (B, iters)

    return solve


def cmfwisa_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a complex batch Vs (B, m, n) against frozen magnitude
    dictionaries — phase-aware serving (King 2012's CMF with the W
    update disabled): per problem it fits the per-source encodings H
    and unit-modulus phase matrices P with V_i ~ sum_s (W_s H_s) .* P_s.

    Per-problem trajectories are exactly ``cmfwisa(V_i, ks,
    W_init=[W_s], W_fixed=True)`` — including the entry unit-L2 column
    normalization of W (cmfwisa.m:154; identity for trained
    dictionaries) and the default phase init exp(1j angle(V_i))
    (cmfwisa.m:119).  All B problems run as one fused device program.

    Parameters: W — one (m, k) array or a LIST of per-source magnitude
    dictionaries (e.g. from per-source nmf/cmfwisa training runs);
    H_init (B, k, n) or per-source list; P_init (B, S, m, n) complex or
    per-source list of (B, m, n) (default exp(1j angle(V)) per source);
    P_fixed (scalar-or-per-source — freeze known phases); H_sparsity
    (scalar-or-per-source); maxiter (100); seed; dtype; eps; mesh (problems
    shard over the batch axis); device_output (True keeps the factors on
    device — P then comes back as a (P_re, P_im) pair of REAL device arrays,
    each (B, S, m, n), because no complex buffer crosses the program
    boundary (models/cmfwisa.py); reassemble with jax.lax.complex inside a
    jitted consumer).  Returns Result with W (m, k, normalized),
    H (B, k, n), P (B, S, m, n) — per-source lists when W was a list —
    and cost (B, maxiter).
    """
    from ..core import real_dtype_of
    cfg = merge_config(config, kwargs)
    for key_, why in [
            ("divergence", "cmfwisa is complex-euclidean only "
                           "(cmfwisa.m:214-217)"),
            ("data_dtype", "the complex fields read V at compute "
                           "precision"),
            ("weights", "the complex objective has no weighted form "
                        "here")]:
        if cfg.get(key_):
            raise ValueError(f"cmfwisa_encode: {key_!r} does not apply — "
                             f"{why}")
    _reject_encode_config(cfg, "cmfwisa_encode")
    # Device-resident ingestion: a (V_re, V_im) pair of real (B, m, n)
    # arrays is taken as the complex batch's planes, already (or about
    # to be) on device — the repeat-serving path that skips the host
    # complex array and its per-call upload entirely.
    planes_in = (isinstance(Vs, tuple) and len(Vs) == 2
                 and not hasattr(Vs[0], "keys"))
    if planes_in:
        V_re_in = jnp.asarray(Vs[0])
        V_im_in = jnp.asarray(Vs[1], V_re_in.dtype)
        rdt = jnp.dtype(cfg.get("dtype") or V_re_in.dtype)
        if jnp.issubdtype(rdt, jnp.complexfloating):
            rdt = real_dtype_of(rdt)
        cdt = (jnp.dtype(np.complex128) if rdt == jnp.float64
               else jnp.dtype(np.complex64))
        V_re_in = V_re_in.astype(rdt)
        V_im_in = V_im_in.astype(rdt)
        if V_re_in.ndim != 3 or V_re_in.shape != V_im_in.shape:
            raise ValueError(
                f"cmfwisa_encode plane inputs must both be (B, m, n); got "
                f"{V_re_in.shape} and {V_im_in.shape}")
        B, m, n = V_re_in.shape
        Vs = None
    else:
        cdt = resolve_dtype(Vs, cfg.get("dtype"))
        if not jnp.issubdtype(cdt, jnp.complexfloating):
            cdt = (jnp.dtype(np.complex128) if cdt == jnp.float64
                   else jnp.dtype(np.complex64))
        rdt = real_dtype_of(cdt)
        Vs = np.asarray(Vs, cdt)  # host; only real planes ship to device
        if Vs.ndim != 3:
            raise ValueError(f"cmfwisa_encode expects Vs of shape (B, m, n) "
                             f"or a (V_re, V_im) plane pair; got {Vs.shape} "
                             "(encode a single matrix with "
                             "cmfwisa(V, ks, W_init=W, W_fixed=True))")
        B, m, n = Vs.shape
    _check_batch_mesh(B, cfg.get("mesh"), "cmfwisa_encode")
    w_list, w_was_seq = as_list(W)
    w_list = [jnp.asarray(w, rdt) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 2 or w.shape[0] != m:
            raise ValueError(f"dictionary W[{s}] must be (m, k) = ({m}, k); "
                             f"got {w.shape}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = unit_l2_columns(jnp.concatenate(w_list, axis=1))  # cmfwisa.m:154
    k = W.shape[1]
    maxiter, _, eps, key = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(key, (B, k, n), rdt)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = jnp.concatenate([jnp.asarray(h, rdt) for h in H0], axis=1)
    H0 = jnp.asarray(H0, rdt)
    if H0.shape != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {H0.shape}")

    P0 = cfg.get("P_init")
    if P0 is None and planes_in:
        # default exp(1j angle(V)) computed on device from the planes
        # (cmfwisa.m:119); np.angle(0) == 0 -> P == 1 matches arctan2.
        @jax.jit
        def _unit_phase(re, im):
            ang = jnp.arctan2(im, re)
            return jnp.cos(ang), jnp.sin(ang)
        pr, pi = _unit_phase(V_re_in, V_im_in)
        P_re0 = jnp.broadcast_to(pr[:, None], (B, S, m, n))
        P_im0 = jnp.broadcast_to(pi[:, None], (B, S, m, n))
    else:
        if P0 is None:
            P0 = np.broadcast_to(
                np.exp(1j * np.angle(Vs)).astype(cdt)[:, None],
                (B, S, m, n))  # cmfwisa.m:119 per problem
        elif isinstance(P0, (list, tuple)):
            if len(P0) != S:
                raise ValueError(f"Requested {S} sources. Given {len(P0)} "
                                 "initial phase matrices.")
            P0 = np.stack([np.asarray(p, cdt) for p in P0], axis=1)
        P0 = np.asarray(P0, cdt)
        if P0.shape != (B, S, m, n):
            raise ValueError(f"P_init must be {(B, S, m, n)} (or a list of "
                             f"S (B, m, n) per-source arrays); got "
                             f"{P0.shape}")
        P_re0, P_im0 = (jnp.asarray(P0.real, rdt), jnp.asarray(P0.imag, rdt))
    p_fx = tuple(bool(x) for x in
                 promote_per_source(cfg.get("P_fixed"), S, "P_fixed", False))
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, rdt)

    # Complex arrays cross the device boundary as real planes.
    if planes_in:
        V_re, V_im = V_re_in, V_im_in
    else:
        V_re, V_im = jnp.asarray(Vs.real, rdt), jnp.asarray(Vs.imag, rdt)
    P_re, P_im = P_re0, P_im0
    mesh = cfg.get("mesh")
    V_re, W, H0, P_re = apply_placements(mesh, "cmfwisa_encode",
                                         V=V_re, W=W, H=H0, P=P_re)
    if mesh is not None:
        V_im = apply_placements(mesh, "cmfwisa_encode", V=V_im)
        P_im = apply_placements(mesh, "cmfwisa_encode", P=P_im)

    spec = _CmfEncSpec(maxiter, eps, blocks, p_fx)
    H, P_re_o, P_im_o, costs = _build_cmf_encode_solver(spec)(
        V_re, V_im, W, H0, P_re, P_im, hsp)
    if cfg.get("device_output"):
        # Serving option: factors stay jax arrays.  Because no complex
        # buffer crosses the program boundary (models/cmfwisa.py), P is
        # returned as a (P_re, P_im) pair of REAL device arrays, each
        # (B, S, m, n) — reassemble inside your own jitted consumer with
        # jax.lax.complex(P_re, P_im).
        Wo = ([W[:, a:b] for a, b in blocks] if w_was_seq else W)
        Ho = ([H[:, a:b] for a, b in blocks] if w_was_seq else H)
        return Result(fields=("W", "H", "P", "cost"), W=Wo, H=Ho,
                      P=(P_re_o, P_im_o), cost=np.asarray(costs),
                      n_iters=maxiter, converged=False)
    P = np.asarray(P_re_o) + 1j * np.asarray(P_im_o)  # (B, S, m, n)
    P_parts = [P[:, s] for s in range(S)]
    return Result(fields=("W", "H", "P", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 1, w_was_seq),
                  P=P_parts if w_was_seq else P_parts[0],
                  cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)


class _Nmf2dEncSpec(NamedTuple):
    iters: int
    eps: float
    div: str
    T: int
    P: int
    alpha: float = 1.0
    beta: float = 1.0
    cost_every: int = 1


@functools.lru_cache(maxsize=None)
def _build_nmf2d_encode_solver(spec: _Nmf2dEncSpec):
    """H-only 2-D deconvolutional MU against one shared (m, k, T)
    dictionary — batched pitch-invariant transcription (every problem's
    H (k, n, P) is a piano roll against the frozen note shapes).

    Trajectories pin against nmf2d(V, k, T, P, W_init=W, W_fixed=True)
    per problem.  Loop-invariant hoists: euclidean's V-term
    gneg[.,.,p] = conv_wt_phi(W, shift_up(V, p)) (iterations never read
    V again); KL's paper-correct shifted ones-field gpos (constant in
    H).  IS/AB recompute both fields (nonlinear in the reconstruction).
    """
    from ..ops.shift import (conv_reconstruct_2d, conv_wt_phi,
                             shift_up_rows)
    T, P = spec.T, spec.P
    a, b = spec.alpha, spec.beta
    dual = a == 0.0
    power = (1.0 / b) if dual else (None if a == 1.0 else 1.0 / a)
    euclid = spec.div == "euclidean" and a == 1.0 and b == 1.0
    kl = spec.div == "kl"
    ce = int(spec.cost_every)

    @jax.jit
    def solve(Vs, W, H0, hsp):
        dt = W.dtype
        eps = jnp.asarray(spec.eps, dt)

        def h_grad(Phi):
            return jnp.stack([conv_wt_phi(W, shift_up_rows(Phi, p))
                              for p in range(P)], axis=2)  # (k, n, P)

        if euclid:
            Gneg = jax.vmap(h_grad)(Vs)  # one-time V term per problem
        if kl:
            ones = jnp.ones(Vs.shape[1:], dt)
            gpos_kl = h_grad(ones)       # paper-correct shifted ones-field

        def one_update(V, gneg_v, H):
            Lam = conv_reconstruct_2d(W, H)
            phi_neg, phi_pos, _ = dv.ab_fields(V, Lam, a, b)
            gneg = gneg_v if euclid else h_grad(phi_neg)
            gpos = gpos_kl if kl else h_grad(phi_pos)
            gneg = dv.apply_power(gneg, power)
            gpos = dv.apply_power(gpos, power)
            return H * (gneg / jnp.maximum(gpos + hsp[:, None, None], eps))

        def one_cost(V, Hn):
            # the objective's own 2-D reconstruction — a SECOND full
            # T*P-shift pass per iteration; cost_every > 1 drops it on
            # skipped steps
            c = dv.cost(spec.div, V, conv_reconstruct_2d(W, Hn), a, b)
            return c + jnp.sum(hsp * jnp.sum(jnp.abs(Hn), axis=(1, 2)))

        upd_b = jax.vmap(one_update, in_axes=(0, 0 if euclid else None, 0))
        cost_b = jax.vmap(one_cost, in_axes=(0, 0))

        if ce == 1:
            def body(H, _):
                Hn = upd_b(Vs, Gneg if euclid else None, H)
                return Hn, cost_b(Vs, Hn)

            H, costs = jax.lax.scan(body, H0, None, length=spec.iters)
            return H, costs.T  # (B, iters)

        return _cadenced_encode(
            lambda H: upd_b(Vs, Gneg if euclid else None, H),
            lambda H: cost_b(Vs, H), H0, ce, spec.iters, dt)

    return solve


def nmf2d_encode(Vs, W, pitch_len: int, config: dict | None = None,
                 **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen 2-D deconvolutional
    dictionary W (m, k, T) with ``pitch_len`` frequency shifts — batched
    pitch-invariant transcription: each problem's H (k, n, P) reads as a
    piano roll (time x pitch activations of the frozen note shapes).

    Per-problem trajectories are exactly
    ``nmf2d(V_i, k, T, P, W_init=W, W_fixed=True)``, including the entry
    cross-frame normalization with norm transfer into every problem's
    H init.  Euclidean iterations never touch V after a one-time
    per-problem gradient; KL hoists its paper-correct shifted
    ones-field.

    Gauge note: nmf2d's model has a (W pitch-shift <-> H pitch-shift)
    degeneracy, so a LEARNED dictionary may carry a constant vertical
    offset — absolute pitch labels from argmax(H) are then shifted by a
    constant.  Calibrate once against a known event from the training
    fit (the activations are consistent across problems; see the
    end-to-end transcription drive in the commit history).

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' +
    alpha/beta incl. the alpha=0 dual), H_init (B, k, n, P), H_sparsity
    (scalar), maxiter (100), seed, dtype, eps, mesh (problems shard over
    the batch axis), device_output, cost_every (int, default 1:
    objective trace every N iterations — the objective is a SECOND full
    T*P-shift reconstruction per iteration, so skipped evaluations
    roughly halve euclid/KL per-iteration work; update math unchanged).
    Returns Result with W (m, k, T, normalized), H (B, k, n, P),
    cost (B, maxiter).
    """
    from ..ops.normalize import cross_frame_norm
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0),
                               cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    _reject_encode_config(cfg, "nmf2d_encode")
    if cfg.get("data_dtype") is not None:
        raise ValueError("nmf2d_encode: data_dtype is not supported — the "
                         "one-time V gradient and the field paths read V "
                         "at compute precision")
    if cfg.get("weights") is not None:
        raise ValueError("nmf2d_encode: weights= is not supported")
    dtype = resolve_dtype(Vs, cfg.get("dtype"))
    Vs = jnp.asarray(Vs, dtype)
    if Vs.ndim != 3:
        raise ValueError(f"nmf2d_encode expects Vs of shape (B, m, n); got "
                         f"{Vs.shape} (encode a single matrix with "
                         "nmf2d(V, k, T, P, W_init=W, W_fixed=True))")
    B, m, n = Vs.shape
    P = int(pitch_len)
    if P < 1 or P > m:
        raise ValueError(f"pitch_len must be in [1, {m}]; got {P}")
    _check_batch_mesh(B, cfg.get("mesh"), "nmf2d_encode")
    W = jnp.asarray(W, dtype)
    if W.ndim != 3 or W.shape[0] != m:
        raise ValueError(f"dictionary W must be (m, k, T) with m = {m}; "
                         f"got {W.shape}")
    k, T = W.shape[1], W.shape[2]
    maxiter, _, eps, key = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(key, (B, k, n, P), dtype)
    H0 = jnp.asarray(H0, dtype)
    if H0.shape != (B, k, n, P):
        raise ValueError(f"H_init must be {(B, k, n, P)}; got {H0.shape}")
    # Entry normalization with norm transfer into every problem's init
    # (models/nmf2d.py _renorm convention, W_fixed included).
    W, norms = cross_frame_norm(W, None, T, return_norms=True)
    H0 = H0 * norms[None, :, None, None]
    hsp = jnp.full((k,), max(float(cfg.get("H_sparsity") or 0.0), 0.0),
                   dtype)

    mesh = cfg.get("mesh")
    Vs, W, H0 = apply_placements(mesh, "nmf2d_encode", V=Vs, W=W, H=H0)

    spec = _Nmf2dEncSpec(maxiter, eps, div, T, P, alpha, beta,
                         _parse_cost_every(cfg))
    H, costs = _build_nmf2d_encode_solver(spec)(Vs, W, H0, hsp)
    if cfg.get("device_output"):
        return Result(fields=("W", "H", "cost"), W=W, H=H,
                      cost=np.asarray(costs), n_iters=maxiter,
                      converged=False)
    return Result(fields=("W", "H", "cost"),
                  W=np.asarray(W), H=np.asarray(H),
                  cost=np.asarray(costs),
                  n_iters=maxiter, converged=False)
