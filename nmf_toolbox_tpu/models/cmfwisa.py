"""Complex matrix factorization with intra-source additivity (King 2012).

Accelerator re-design of cmfwisa.m: V ~ sum_i (W_i H_i) .* P_i where W/H
are non-negative real factors and P_i are unit-modulus complex phase
matrices.  Runs in native complex64 (complex128 under x64) on device.

Reproduced reference semantics:
* auxiliary ratios beta_i = (W_i H_i) / (W_all H_all) and per-source
  targets V_bar_i = V_hat_i + beta_i (V - V_hat) (cmfwisa.m:177-180);
* phase update P_i = exp(1j angle(V_bar_i)) (cmfwisa.m:185);
* W/H multiplicative updates against the STALE full reconstruction
  (W_all/H_all rebuilt only after both updates — cmfwisa.m:192-205), the
  H denominator with the reference's (W_i' W_all) H_all association;
* cost = sum |V - V_hat|^2 + sum_i H_sparsity_i sum(H_i)
  (cmfwisa.m:214-217 — no 0.5 factor);
* W_sparsity is accepted but ignored, exactly like the reference (the
  validation surface admits it but no update uses it — see COMPAT.md).

Device-first: per-source reconstructions are one stacked (S, m, n) tensor;
the shared denominators are single concatenated matmuls sliced per block.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import (common_scalars, Result, as_list, merge_config, per_column,
                    promote_inits, promote_per_source, resolve_dtype,
                    source_blocks, unwrap_sources, uniform_init,
                    real_dtype_of)
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns
from ..parallel import apply_placements, pad_axes, plan_padding


class _Spec(NamedTuple):
    maxiter: int
    w_fixed: tuple
    h_fixed: tuple
    p_fixed: tuple
    blocks: tuple
    eps: float
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem


@functools.lru_cache(maxsize=None)
def _build_solver(spec: _Spec):
    blocks = spec.blocks
    S = len(blocks)

    @jax.jit
    def solve(V_re, V_im, W0, H0, P_re, P_im, hsp, tolerance):
        # The complex data/phase cross the jit boundary as real planes,
        # so no host<->device transfer carries a complex buffer.  All
        # complex arithmetic lives in here; inputs and outputs are real.
        V = jax.lax.complex(V_re, V_im)
        P0 = jax.lax.complex(P_re, P_im)
        rdt = W0.dtype
        eps = jnp.asarray(spec.eps, rdt)
        rzero = jnp.zeros((), rdt)
        # Pad region of a mesh-padded problem: WH and R are exactly 0
        # there, so beta and G are unguarded 0/0 (as in the reference's
        # valid math, which never sees zeros) — pin them to zero.
        mask = region_mask(V.shape, spec.valid)

        def per_source_wh(W, H):
            # stacked (S, m, n) per-source reconstructions W_i @ H_i
            return jnp.stack([W[:, a:b] @ H[a:b, :] for a, b in blocks])

        def step(carry, i):
            W, H, P, WH = carry
            V_hat = jnp.sum(WH * P, axis=0)
            R = jnp.sum(WH, axis=0)                # stale W_all H_all (real)
            beta = WH / R                          # cmfwisa.m:178
            if mask is not None:
                beta = jnp.where(mask[None], beta, rzero)
            V_bar = WH * P + beta * (V - V_hat)    # cmfwisa.m:179
            # Phase update (cmfwisa.m:183-187).
            P_new = jnp.exp(1j * jnp.angle(V_bar)).astype(P.dtype)
            if any(spec.p_fixed):
                P = jnp.stack([P[s] if spec.p_fixed[s] else P_new[s]
                               for s in range(S)])
            else:
                P = P_new
            G = jnp.abs(V_bar) / beta              # (S, m, n) real
            if mask is not None:
                G = jnp.where(mask[None], G, rzero)

            # W updates (cmfwisa.m:190-195) — denominators share R @ H_i'.
            RHt = R @ H.T                          # (m, k_all)
            cols = []
            for s, (a, b) in enumerate(blocks):
                if spec.w_fixed[s]:
                    cols.append(W[:, a:b])
                else:
                    num = G[s] @ H[a:b, :].T
                    Ws = W[:, a:b] * (num / jnp.maximum(RHt[:, a:b], eps))
                    cols.append(unit_l2_columns(Ws))
            W_new = jnp.concatenate(cols, axis=1)

            # H updates (cmfwisa.m:198-202) — W_i is the UPDATED block, the
            # denominator (W_i' W_all) H_all uses the stale factors.
            M = (W_new.T @ W) @ H                  # (k_all, n); W/H stale
            rows = []
            for s, (a, b) in enumerate(blocks):
                if spec.h_fixed[s]:
                    rows.append(H[a:b, :])
                else:
                    num = W_new[:, a:b].T @ G[s]
                    rows.append(H[a:b, :] * (num / jnp.maximum(M[a:b, :] + hsp[a:b, None], eps)))
            H_new = jnp.concatenate(rows, axis=0)

            WH_new = per_source_wh(W_new, H_new)
            V_hat = jnp.sum(WH_new * P, axis=0)
            diff = V - V_hat
            c = jnp.sum(jnp.real(diff * jnp.conj(diff)))
            c = c + jnp.sum(hsp * jnp.sum(H_new, axis=1))
            return (W_new, H_new, P, WH_new), c, jnp.asarray(False)

        WH0 = per_source_wh(W0, H0)
        out = looplib.run(step, (W0, H0, P0, WH0), spec.maxiter, tolerance,
                          cost_dtype=rdt)
        W, H, P, _ = out.state
        # complex -> real planes for the transfer back (see above)
        return out._replace(state=(W, H, jnp.real(P), jnp.imag(P)))
    return solve


def cmfwisa(V, num_basis_elems, config: dict | None = None, **kwargs):
    """Complex MF with intra-source additivity.  Returns (W, H, P, cost).

    Parameters (cmfwisa.m:10-80): W_init/H_init (real, per-source),
    P_init (complex unit-modulus, default exp(1j angle(V))),
    W_sparsity (accepted, unused — reference parity), H_sparsity,
    W_fixed/H_fixed/P_fixed, maxiter (100), tolerance (1e-3).
    """
    cfg = merge_config(config, kwargs)
    cdt = resolve_dtype(V, cfg.get("dtype"))
    if not jnp.issubdtype(cdt, jnp.complexfloating):
        cdt = jnp.dtype(np.complex128) if cdt == jnp.float64 else jnp.dtype(np.complex64)
    rdt = real_dtype_of(cdt)
    V = np.asarray(V, cdt)  # stays on host; only real planes ship to device
    m, n = V.shape

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)

    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    # W_sparsity: accepted but unused (reference behavior, cmfwisa.m).
    promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)
    w_fx = tuple(bool(x) for x in promote_per_source(cfg.get("W_fixed"), S, "W_fixed", False))
    h_fx = tuple(bool(x) for x in promote_per_source(cfg.get("H_fixed"), S, "H_fixed", False))
    p_fx = tuple(bool(x) for x in promote_per_source(cfg.get("P_fixed"), S, "P_fixed", False))
    maxiter, tolerance, eps, key = common_scalars(cfg)
    kw, kh = jax.random.split(key)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    p_list, p_was_seq = promote_inits(cfg.get("P_init"), S, "phase")
    if w_list is None:
        keys = jax.random.split(kw, S)
        w_list = [unit_l2_columns(uniform_init(kk, (m, k), rdt))
                  for kk, k in zip(keys, ks)]
        w_was_seq = was_seq
    if h_list is None:
        keys = jax.random.split(kh, S)
        h_list = [uniform_init(kk, (k, n), rdt) for kk, k in zip(keys, ks)]
        h_was_seq = was_seq
    if p_list is None:
        p0 = np.exp(1j * np.angle(V)).astype(cdt)  # cmfwisa.m:119
        p_list = [p0] * S
        p_was_seq = was_seq

    W0 = unit_l2_columns(jnp.concatenate([jnp.asarray(w, rdt) for w in w_list], axis=1))
    H0 = jnp.concatenate([jnp.asarray(h, rdt) for h in h_list], axis=0)
    P0 = np.stack([np.asarray(p, cdt) for p in p_list])
    hsp = per_column(h_sp, ks, rdt)

    # Complex arrays cross the device boundary as real planes (see solve).
    V_re, V_im = jnp.asarray(V.real, rdt), jnp.asarray(V.imag, rdt)
    P_re, P_im = jnp.asarray(P0.real, rdt), jnp.asarray(P0.imag, rdt)

    mesh = cfg.get("mesh")
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V_re = pad_axes(V_re, {0: pad_m, 1: pad_n})
        V_im = pad_axes(V_im, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
        P_re = pad_axes(P_re, {1: pad_m, 2: pad_n})
        P_im = pad_axes(P_im, {1: pad_m, 2: pad_n})
    V_re, W0, H0, P_re = apply_placements(mesh, "cmfwisa",
                                          V=V_re, W=W0, H=H0, P=P_re)
    if mesh is not None:
        V_im = apply_placements(mesh, "cmfwisa", V=V_im)
        P_im = apply_placements(mesh, "cmfwisa", P=P_im)

    spec = _Spec(maxiter, w_fx, h_fx, p_fx, blocks, eps, valid)
    out = _build_solver(spec)(V_re, V_im, W0, H0, P_re, P_im, hsp,
                              jnp.asarray(tolerance, rdt))
    W, H, P_re_o, P_im_o = out.state
    if valid is not None:
        W, H = W[:m], H[:, :n]
        P_re_o, P_im_o = P_re_o[:, :m, :n], P_im_o[:, :m, :n]
    P = np.asarray(P_re_o) + 1j * np.asarray(P_im_o)
    P_parts = [P[s] for s in range(S)]
    return Result(
        fields=("W", "H", "P", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        P=P_parts if p_was_seq else P_parts[0],
        cost=looplib.trim_cost(out, maxiter),
        n_iters=int(out.n_iters), converged=bool(out.stopped),
    )
