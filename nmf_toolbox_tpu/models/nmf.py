"""NMF with multiplicative updates over four divergences.

Accelerator re-design of the reference solver (nmf.m):

* Multi-source "cell arrays" (nmf.m:114-117) become static column blocks
  of one concatenated (m, k_total) basis — the per-source diagonal
  correction terms of nmf.m:149-150 are column-local, so the hot loop has
  no per-source logic at all.
* Euclidean mode runs in **Gram form**: the m-by-n reconstruction W @ H is
  never materialized.  Per iteration only two full-size matmuls remain
  (V @ H' and W' @ V); every other term is assembled from k-by-k Grams,
  and the cost uses the identity
  0.5*||V - WH||^2 = 0.5*(||V||^2 - 2<W'V, H> + <W'W H, H>).
  This is mathematically identical to nmf.m:147-224 (different floating-
  point association only) and cuts both FLOPs and HBM traffic ~3x.
* KL/IS/AB modes materialize the reconstruction (the fields are nonlinear
  in V_hat) — see ops/divergence.py; the ones-field of KL is kept
  implicit (no m-by-n ones matrix, nmf.m:152-153).
* The iteration loop runs on device in ``lax.while_loop`` with the
  tolerance check of nmf.m:221-224 evaluated on device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, as_list, default_h_init, default_w_init,
                    fixed_col_mask, merge_config, parse_cost_every, per_column,
                    promote_inits, promote_per_source, resolve_dtype,
                    source_blocks, unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, sq_norm
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns
from ..parallel import (apply_placements, pad_axes, plan_padding,
                        prepare_weights)


FUSED_MAX_K = 128  # method='fused': rank the kernel's tiles are sized for


class _Spec(NamedTuple):
    divergence: str
    alpha: float
    beta: float
    method: str          # 'gram' | 'naive' | 'fused'
    maxiter: int
    w_fixed: tuple
    h_fixed: tuple
    blocks: tuple
    eps: float
    callback: object = None  # optional (i, cost) host logger
    valid: tuple = None      # (m, n) true sizes of a mesh-padded problem
    inner: int = 1           # accelerated-MU inner repetitions (gram only)
    cost_every: int = 1      # objective cadence (1 = reference semantics)
    interpret: bool = False  # 'fused' on CPU: Pallas interpreter


def _kl_ones_b(H, m):
    """ones(m, n) @ H' without the m-by-n ones matrix (nmf.m:153)."""
    return jnp.broadcast_to(jnp.sum(H, axis=1)[None, :], (m, H.shape[0]))


def _kl_ones_pos_h(W, n):
    """W' @ ones(m, n) without the ones matrix (nmf.m:184)."""
    return jnp.broadcast_to(jnp.sum(W, axis=0)[:, None], (W.shape[1], n))


def _sparsity_penalty(W, H, wsp, hsp):
    """Per-source L1 penalties added to the cost (nmf.m:216-218)."""
    return (jnp.sum(wsp * jnp.sum(jnp.abs(W), axis=0))
            + jnp.sum(hsp * jnp.sum(jnp.abs(H), axis=1)))


@functools.lru_cache(maxsize=None)
def _build_solver_cached(spec: _Spec):
    return _build_solver_impl(spec)


def _build_solver(spec: _Spec):
    if spec.callback is not None:
        # Debug callbacks embed arbitrary Python closures in the jitted
        # graph; build fresh instead of leaking one cache entry per lambda.
        return _build_solver_impl(spec)
    return _build_solver_cached(spec)


def _build_solver_impl(spec: _Spec):
    div, alpha, beta = spec.divergence, spec.alpha, spec.beta
    w_any = not all(spec.w_fixed)
    h_any = not all(spec.h_fixed)
    ks = [b - a for a, b in spec.blocks]
    w_mask = fixed_col_mask(spec.w_fixed, ks)
    h_mask = fixed_col_mask(spec.h_fixed, ks)
    w_all_free = not any(spec.w_fixed)
    h_all_free = not any(spec.h_fixed)
    ce = int(spec.cost_every)
    # ``cost_every`` tail: evaluate the objective only on check
    # iterations, carrying the last value in between (see
    # ops/loop.cost_cadence for the cadence + stop-rule semantics).
    cadence = looplib.cost_cadence(ce, spec.maxiter)

    def finish_step(W, H, carry, i, cost_fn):
        return cadence((W, H), carry, i, cost_fn)

    def gram_step(V, v_sq, wsp, hsp, eps):
        cdt = jnp.promote_types(V.dtype, jnp.float32)  # accumulation dtype

        def vdot(A, B):
            # V may be stored bf16 (data_dtype option): feed the matmul the
            # storage dtype, accumulate in f32.
            return jax.lax.dot(A, B.astype(A.dtype),
                               preferred_element_type=cdt)

        def step(carry, i):
            W, H = carry[0], carry[1]
            if w_any:
                HHt = H @ H.T
                VHt = vdot(V, H.T)                 # [mnk]
                # Accelerated MU (Gillis & Glineur 2012, arXiv:1107.5194):
                # VHt and HHt depend only on the V data and the fixed H,
                # so the W step can repeat `inner` times reusing them —
                # each extra rep costs one m-by-k^2 product instead of the
                # m-by-n-by-k V dot.  inner=1 is the reference trajectory.
                for _ in range(spec.inner):
                    WG = W @ HHt                   # = V_hat @ H'
                    dneg = jnp.sum(W * WG, axis=0)  # diag(Hs V_hat' Ws)
                    dpos = jnp.sum(W * VHt, axis=0)  # diag(Hs V' Ws)
                    neg = VHt + W * dneg[None, :]
                    pos = WG + W * dpos[None, :]
                    Wn = W * (neg / jnp.maximum(pos + wsp[None, :], eps))
                    Wn = unit_l2_columns(Wn)
                    W = Wn if w_all_free else jnp.where(w_mask[None, :], W, Wn)
            WtV = vdot(V.T, W).T                   # [mnk]
            WtW = W.T @ W
            if h_any:
                for _ in range(spec.inner):
                    Hn = H * (WtV / jnp.maximum(WtW @ H + hsp[:, None], eps))
                    H = Hn if h_all_free else jnp.where(h_mask[:, None], H, Hn)

            def cost_fn():
                c = euclidean_cost_gram(v_sq, WtV, WtW, H)
                return c + _sparsity_penalty(W, H, wsp, hsp)
            return finish_step(W, H, carry, i, cost_fn)
        return step

    def naive_step(V, v_sq, wsp, hsp, eps, Mw=None):
        m, n = V.shape
        mask = region_mask(V.shape, spec.valid)

        def step(carry, i):
            W, H = carry[0], carry[1]
            V_hat = W @ H
            if w_any:
                phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                    mask=mask, weights=Mw)
                A = phi_neg @ H.T
                B = _kl_ones_b(H, m) if phi_pos is None else phi_pos @ H.T
                dneg = jnp.sum(W * B, axis=0)
                dpos = jnp.sum(W * A, axis=0)
                neg = dv.apply_power(A + W * dneg[None, :], power)
                pos = dv.apply_power(B + W * dpos[None, :], power)
                Wn = W * (neg / jnp.maximum(pos + wsp[None, :], eps))
                Wn = unit_l2_columns(Wn)
                W = Wn if w_all_free else jnp.where(w_mask[None, :], W, Wn)
                V_hat = W @ H
            if h_any:
                phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                    mask=mask, weights=Mw)
                neg = dv.apply_power(W.T @ phi_neg, power)
                pos = _kl_ones_pos_h(W, n) if phi_pos is None else W.T @ phi_pos
                pos = dv.apply_power(pos, power)
                Hn = H * (neg / jnp.maximum(pos + hsp[:, None], eps))
                H = Hn if h_all_free else jnp.where(h_mask[:, None], H, Hn)

            def cost_fn():
                # The reconstruction here is the one m-by-n matmul whose
                # ONLY consumer is the objective; with cost_every > 1 the
                # skipped iterations drop it (and the divergence-field
                # pass) entirely.  With cost_every == 1 XLA CSEs it
                # against any identical dot above — bit-identical to the
                # pre-knob step.
                c = dv.cost(div, V, W @ H, alpha, beta, mask=mask,
                            weights=Mw)
                return c + _sparsity_penalty(W, H, wsp, hsp)
            return finish_step(W, H, carry, i, cost_fn)
        return step

    def fused_step(V, v_sq, wsp, hsp, eps):
        """KL iteration whose W phase ``(V / (W @ H)) @ H'`` runs as one
        Pallas/Triton kernel (ops/fused_kl.py): the m-by-n reconstruction
        and ratio fields of that phase never reach device memory.  The H
        phase and the cost are the naive step's."""
        from ..ops.fused_kl import kl_ratio_dot_ht
        n = V.shape[1]

        def step(carry, i):
            W, H = carry[0], carry[1]
            if w_any:
                A = kl_ratio_dot_ht(V, W, H, interpret=spec.interpret)
                h_rowsum = jnp.sum(H, axis=1)
                dneg = jnp.sum(W, axis=0) * h_rowsum
                dpos = jnp.sum(W * A, axis=0)
                neg = A + W * dneg[None, :]
                pos = h_rowsum[None, :] + W * dpos[None, :]
                Wn = W * (neg / jnp.maximum(pos + wsp[None, :], eps))
                Wn = unit_l2_columns(Wn)
                W = Wn if w_all_free else jnp.where(w_mask[None, :], W, Wn)
            if h_any:
                neg = W.T @ (V / (W @ H))
                pos = _kl_ones_pos_h(W, n)
                Hn = H * (neg / jnp.maximum(pos + hsp[:, None], eps))
                H = Hn if h_all_free else jnp.where(h_mask[:, None], H, Hn)

            def cost_fn():
                c = dv.cost(div, V, W @ H, alpha, beta)
                return c + _sparsity_penalty(W, H, wsp, hsp)
            return finish_step(W, H, carry, i, cost_fn)
        return step

    make_step = {"gram": gram_step, "naive": naive_step,
                 "fused": fused_step}[spec.method]

    @jax.jit
    def solve(V, W0, H0, wsp, hsp, tolerance, Mw=None):
        eps = jnp.asarray(spec.eps, W0.dtype)
        v_sq = sq_norm(V.astype(W0.dtype)) if spec.method == "gram" else None
        if Mw is None:
            step = make_step(V, v_sq, wsp, hsp, eps)
        else:
            # per-entry weights: naive path only (wrapper enforces)
            step = make_step(V, v_sq, wsp, hsp, eps, Mw)
        return looplib.run(step, looplib.cadence_state((W0, H0), ce,
                                                       W0.dtype),
                           spec.maxiter, tolerance,
                           cost_dtype=W0.dtype, callback=spec.callback)

    return solve


def nmf(V, num_basis_elems, config: dict | None = None, **kwargs):
    """Decompose a non-negative matrix V ~ W @ H.

    Parameter surface mirrors the reference (nmf.m:17-65): ``divergence``
    ('euclidean' | 'kl' | 'is' | 'ab' + aliases), ``alpha``/``beta`` (AB
    only), ``W_init``/``H_init`` (array or per-source list),
    ``W_sparsity``/``H_sparsity``, ``W_fixed``/``H_fixed``,
    ``maxiter`` (100), ``tolerance`` (1e-3).  Extras: ``dtype``, ``seed``,
    ``method`` ('auto' | 'gram' | 'naive' | 'fused': KL only, float32,
    k <= 128, one GPU — the W phase as one Pallas/Triton kernel), ``eps``,
    ``init`` ('nndsvd*' seeding), ``inner_iters`` (accelerated MU, euclidean
    Gram path), ``weights`` ((m, n) nonnegative per-entry weights —
    minimizes sum(weights * d(V, WH)); zero weights mark missing entries),
    ``cost_every`` (int, default 1: evaluate the objective every N
    iterations instead of every iteration — the objective feeds only the
    stopping rule (nmf.m:221-224), never the updates, so the factor
    trajectory is bit-identical while KL/IS/AB/weighted iterations drop
    the objective's reconstruction matmul and divergence-field pass on
    the skipped steps; the stop rule becomes "decrease over the last N
    iterations < tolerance" (sklearn's NMF uses the same every-10 cadence)
    and ``Result.cost`` repeats the last computed value in between).

    Returns a :class:`Result` unpacking as (W, H, cost).
    """
    cfg = merge_config(config, kwargs)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = jnp.asarray(V, dtype)
    m, n = V.shape

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div == "ab":
        alpha = float(cfg.get("alpha", 1.0))
        beta = float(cfg.get("beta", 1.0))
        if alpha == 0.0 and beta == 0.0:
            raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    else:
        alpha, beta = 1.0, 1.0  # forced outside AB (nmf.m:255-266)

    method = cfg.get("method", "auto")
    k_total = sum(ks)
    weights = cfg.get("weights")
    if weights is not None:
        # Per-entry weighted objective (beyond-reference: missing-data /
        # confidence weighting).  The weighted fields need the full
        # reconstruction, so only the naive path applies.
        if method == "auto":
            method = "naive"
        elif method != "naive":
            raise ValueError("weights= requires method='naive' (the "
                             "weighted fields are nonlinear in W @ H)")
    if method == "auto":
        # 'fused' stays opt-in: it covers KL only, float32, one device.
        method = "gram" if div == "euclidean" else "naive"
    if method == "gram" and div != "euclidean":
        raise ValueError("method='gram' is only valid for the euclidean divergence")
    interpret = False
    if method == "fused":
        if div != "kl":
            raise ValueError("method='fused' is only valid for the kl "
                             "divergence")
        if dtype != jnp.float32:
            raise ValueError("method='fused' requires float32")
        if k_total > FUSED_MAX_K:
            raise ValueError(f"method='fused' supports k <= {FUSED_MAX_K} "
                             "(the kernel's register tiles); use "
                             "method='naive'")
        if cfg.get("mesh") is not None:
            raise ValueError("method='fused' runs on one device; use "
                             "method='naive' with a mesh")
        platform = next(iter(V.devices())).platform
        if platform not in ("gpu", "cpu"):
            raise ValueError(f"method='fused' needs a GPU, got {platform!r}")
        # The CPU runs the kernel in the Pallas interpreter (tests only).
        interpret = platform == "cpu"

    w_sp = promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)
    h_sp = promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)
    w_sp = [max(float(v), 0.0) for v in w_sp]
    h_sp = [max(float(v), 0.0) for v in h_sp]
    w_fx = tuple(bool(b) for b in promote_per_source(cfg.get("W_fixed"), S, "W_fixed", False))
    h_fx = tuple(bool(b) for b in promote_per_source(cfg.get("H_fixed"), S, "H_fixed", False))
    maxiter, tolerance, eps, key = common_scalars(cfg)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    init = str(cfg.get("init", "random"))
    if init != "random":
        # Beyond-reference extra: SVD-seeded factors (utils/init.nndsvd).
        if init not in ("nndsvd", "nndsvda", "nndsvdar"):
            raise ValueError(f"unknown init {init!r}; expected 'random', "
                             "'nndsvd', 'nndsvda', or 'nndsvdar'")
        if w_list is not None or h_list is not None:
            raise ValueError("init='nndsvd*' cannot be combined with "
                             "W_init/H_init")
        if S != 1:
            raise ValueError("init='nndsvd*' supports a single source")
        from ..utils.init import nndsvd, seedable
        cdt = jnp.promote_types(dtype, jnp.float32)
        Vs = seedable(V) if cfg.get("weights") is not None else V
        Wn, Hn = nndsvd(Vs.astype(cdt), ks[0], key=key, variant=init)
        # The solver normalizes W columns to unit L2 (nmf.m:132-134);
        # transfer the norms into H first so W @ H is preserved.
        norms = jnp.sqrt(jnp.maximum(jnp.sum(Wn * Wn, axis=0), eps))
        w_list = [(Wn / norms[None, :]).astype(dtype)]
        h_list = [(Hn * norms[:, None]).astype(dtype)]
        w_was_seq = h_was_seq = was_seq
    kw, kh = jax.random.split(key)
    if w_list is None:
        w_list = default_w_init(kw, m, ks, dtype)
        w_was_seq = was_seq
    if h_list is None:
        h_list = default_h_init(kh, ks, n, dtype)
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if np.shape(w) != (m, k):
            raise ValueError(f"W_init[{s}] has shape {np.shape(w)}, expected {(m, k)}")
        if np.shape(h) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {np.shape(h)}, expected {(k, n)}")

    W0 = jnp.concatenate([jnp.asarray(w, dtype) for w in w_list], axis=1)
    H0 = jnp.concatenate([jnp.asarray(h, dtype) for h in h_list], axis=0)
    # Unit-L2 column normalization of the (possibly user-supplied) init
    # (nmf.m:132-134).
    W0 = unit_l2_columns(W0)

    wsp = per_column(w_sp, ks, dtype)
    hsp = per_column(h_sp, ks, dtype)

    data_dtype = cfg.get("data_dtype")
    if data_dtype is not None:
        if method != "gram":
            raise ValueError("data_dtype is only supported with the "
                             "euclidean Gram method")
        V = V.astype(jnp.dtype(data_dtype))

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "nmf", V=V, W=W0, H=H0)
    weights = prepare_weights(weights, dtype, (m, n), mesh, "nmf",
                              pad_m, pad_n, valid)

    inner = cfg.get("inner_iters", 1)
    inner = 1 if inner is None else int(inner)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    if inner > 1 and method != "gram":
        raise ValueError(
            "inner_iters > 1 (accelerated MU) requires the euclidean Gram "
            "method: the KL/IS/AB fields are nonlinear in W @ H, so inner "
            "repetitions would still need the full-size reconstruction")

    spec = _Spec(div, alpha, beta, method, maxiter, w_fx, h_fx, blocks, eps,
                 cfg.get("callback"), valid, inner, parse_cost_every(cfg),
                 interpret)
    solve = _build_solver(spec)
    tol = jnp.asarray(tolerance, dtype)
    if weights is None:
        out = solve(V, W0, H0, wsp, hsp, tol)
    else:
        out = solve(V, W0, H0, wsp, hsp, tol, weights)

    W, H = out.state[0], out.state[1]
    if valid is not None:
        W, H = W[:m], H[:, :n]
    cost = looplib.trim_cost(out, maxiter)
    return Result(
        fields=("W", "H", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        cost=cost,
        n_iters=int(out.n_iters),
        converged=bool(out.stopped),
    )
