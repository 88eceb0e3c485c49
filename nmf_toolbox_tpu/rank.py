"""Rank (number of basis elements) selection for NMF.

The reference leaves ``num_basis_elems`` entirely to the user (every
solver takes it as a required argument, e.g. nmf.m:1, cnmf.m:1); picking
it is the first question every practitioner actually faces.  This module
adds the two standard data-driven answers, built device-first:

1. **Spectral energy** (`estimate_rank_svd`): the smallest k whose
   truncated spectrum captures a target fraction of ||V||_F^2.  Uses the
   randomized SVD from utils/init.py — V is touched only through
   matmuls, no m-by-m or n-by-n matrix is ever formed.

2. **Consensus / stability** (`consensus_stability`, Brunet et al. 2004
   "Metagenes and molecular pattern discovery using matrix
   factorization", PNAS): for each candidate k, factorize from many
   random restarts and measure how consistently pairs of columns
   cluster together.  The S restarts run as ONE fused device program
   (`nmf_multiseed`: vmap over inits, V shared in HBM), so the sweep is
   a handful of batched solves instead of S*len(ranks) dispatches.

`pick_rank` is the front door combining both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .core import merge_config, resolve_dtype
from .models.batched import nmf_multiseed
from .utils.init import _randomized_svd


@dataclasses.dataclass
class RankStats:
    """Stability statistics for one candidate rank."""
    rank: int
    cophenetic: float      # cophenetic correlation of the consensus (1 = stable)
    dispersion: float      # Kim & Park 2007 dispersion of the consensus (1 = crisp)
    consensus: np.ndarray  # (n, n) mean connectivity over restarts
    mean_cost: float       # mean final objective over restarts
    best_cost: float       # best final objective over restarts


@dataclasses.dataclass
class RankSelection:
    """Outcome of a rank sweep.  ``stats`` is ordered as ``ranks``."""
    recommended: int
    ranks: tuple[int, ...]
    stats: list[RankStats]
    method: str


def _consensus_metrics(consensus: np.ndarray) -> tuple[float, float]:
    """(cophenetic correlation, dispersion) of a consensus matrix.

    Cophenetic: average-linkage dendrogram of the dissimilarity
    1 - consensus, correlated against the original dissimilarities
    (Brunet 2004 supplement).  Dispersion: rho = mean(4*(C - 1/2)^2)
    (Kim & Park 2007) — 1 iff every entry is exactly 0 or 1.
    """
    n = consensus.shape[0]
    disp = float(np.mean(4.0 * (consensus - 0.5) ** 2))
    d = 1.0 - consensus
    # Zero-variance guard (scipy's cophenet returns nan there): a
    # UNIFORM dissimilarity near 0 (always one cluster) or near 1
    # (always all-separate) is perfectly consistent -> 1; a uniform
    # mid-value (e.g. 0.5 everywhere: coin-flip co-clustering) is
    # maximal instability -> 0.
    iu = np.triu_indices(n, k=1)
    dv = d[iu]
    if np.allclose(dv, dv[0] if dv.size else 0.0):
        v = float(dv[0]) if dv.size else 0.0
        return (1.0 if (v <= 0.05 or v >= 0.95) else 0.0), disp
    from scipy.cluster.hierarchy import linkage, cophenet
    from scipy.spatial.distance import squareform
    dv_sym = squareform((d + d.T) / 2.0, checks=False)
    Z = linkage(dv_sym, method="average")
    coph, _ = cophenet(Z, dv_sym)
    return float(coph), disp


def estimate_rank_svd(V, energy: float = 0.90, max_rank: int = 64,
                      seed: int = 0, dtype=None, block_size=None):
    """Smallest k capturing ``energy`` of ||V||_F^2, from a randomized SVD.

    Returns (rank, energy_curve) where energy_curve[i] is the fraction
    captured by the top i+1 singular values.  If even ``max_rank``
    components fall short (heavy-tailed spectrum), returns ``max_rank``.

    ``block_size``: OUT-OF-CORE mode — V (e.g. a memory-mapped .npy) is
    streamed in column blocks and only (m, p) / (p, p) arrays ever exist
    on device or host (p = max_rank + oversampling): the range sketch
    and every power iteration accumulate blockwise, orthonormalization
    runs through (p, p) Gram Cholesky-QR, and the spectrum comes from
    the accumulated (p, p) Gram of Q'V — the n axis is never
    materialized.  Completes the out-of-core workflow: estimate the
    rank, then `nmf_streaming` to train and `nmf_encode_streaming` to
    encode, all without V in memory.
    """
    if not (0.0 < energy <= 1.0):
        raise ValueError(f"energy must be in (0, 1]; got {energy}")
    if block_size is not None:
        return _estimate_rank_svd_streaming(V, energy, max_rank, seed,
                                            dtype, int(block_size))
    dtype = resolve_dtype(V, dtype)
    V = jnp.asarray(V, dtype)
    m, n = V.shape
    k = int(min(max_rank, m, n))
    _, s, _ = _randomized_svd(jax.random.PRNGKey(seed), V, k)
    s = np.asarray(s, np.float64)
    # ||V||_F^2 exactly (one device reduction in f32 accumulation),
    # instead of trusting the truncated spectrum's tail.
    acc = jnp.float32 if V.dtype == jnp.bfloat16 else V.dtype
    total = float(jnp.sum(jnp.square(V.astype(acc))))
    # Clip at 1: the randomized spectrum can overestimate individual
    # singular values by O(eps * s_1), pushing the cumulative sum a hair
    # past the exact ||V||_F^2.
    curve = np.minimum(np.cumsum(s ** 2)
                       / max(total, np.finfo(np.float64).tiny), 1.0)
    hit = np.nonzero(curve >= energy)[0]
    rank = int(hit[0]) + 1 if hit.size else k
    return rank, curve


def _estimate_rank_svd_streaming(V, energy, max_rank, seed, dtype,
                                 block, oversample=10, power_iters=2):
    """Blockwise randomized spectrum (Halko 2011 structure, one column-
    block stream per stage).  The (n, p) sketch of the in-memory path is
    replaced by its (p, p) Gram: with Z = V'Q accumulated per block,
    qr(Z) = Z R^{-1} where R'R = Z'Z (Cholesky), so the next range
    sketch V (Z R^{-1}) = (sum_b V_b Z_b) R^{-1} needs only the blockwise
    products — nothing n-sized exists anywhere."""
    from jax.scipy.linalg import solve_triangular
    from .utils.init import _cholesky_qr, _working_eps

    m, n = V.shape
    dtype = resolve_dtype(np.asarray(V[:, :1]), dtype)
    k = int(min(max_rank, m, n))
    p = int(min(k + oversample, m, n))
    eps = jnp.asarray(_working_eps(jnp.dtype(dtype)), dtype)
    key = jax.random.PRNGKey(seed)
    starts = list(range(0, n, block))

    def blocks():
        for bi, a in enumerate(starts):
            yield bi, jnp.asarray(np.asarray(V[:, a:min(a + block, n)]),
                                  dtype)

    # Range sketch Y = V @ Omega, Omega rows drawn per block (fold_in
    # keeps the stream independent of the block partition's seed use).
    Y = jnp.zeros((m, p), dtype)
    total = 0.0
    for bi, Vb in blocks():
        Om_b = jax.random.normal(jax.random.fold_in(key, bi),
                                 (Vb.shape[1], p), dtype)
        Y = Y + Vb @ Om_b
        total += float(jnp.sum(jnp.square(Vb)))  # exact ||V||_F^2
    Q = _cholesky_qr(Y, eps)

    for _ in range(power_iters):
        # One pass accumulates P = V (V'Q) and the Gram S = (V'Q)'(V'Q);
        # the orthonormalized step is P R^{-1} with R = chol(S).
        P = jnp.zeros((m, p), dtype)
        S = jnp.zeros((p, p), dtype)
        for _, Vb in blocks():
            Zb = Vb.T @ Q
            P = P + Vb @ Zb
            S = S + Zb.T @ Zb
        R = jnp.linalg.cholesky(
            S + eps * jnp.trace(S) * jnp.eye(p, dtype=dtype)).T
        Q = _cholesky_qr(solve_triangular(R, P.T, lower=False,
                                          trans="T").T, eps)

    # Spectrum from M = (Q'V)(Q'V)' accumulated blockwise (p, p).
    M = jnp.zeros((p, p), dtype)
    for _, Vb in blocks():
        Bb = Q.T @ Vb
        M = M + Bb @ Bb.T
    vals = jnp.linalg.eigh(M)[0][::-1]
    s = np.sqrt(np.maximum(np.asarray(vals[:k], np.float64), 0.0))
    curve = np.minimum(np.cumsum(s ** 2)
                       / max(total, np.finfo(np.float64).tiny), 1.0)
    hit = np.nonzero(curve >= energy)[0]
    rank = int(hit[0]) + 1 if hit.size else k
    return rank, curve


def consensus_stability(V, ranks, n_seeds: int = 20,
                        stability_tol: float = 0.01,
                        cost_gain: float = 0.2,
                        config: dict | None = None, **kwargs) -> RankSelection:
    """Brunet-style consensus sweep over candidate ``ranks``.

    For each k: ``n_seeds`` NMF restarts (euclidean by default;
    ``divergence='kl'`` for Brunet's original objective) in one fused
    batched program, connectivity C_s[i,j] = 1 iff columns i,j take their argmax
    on the same basis element, consensus = mean_s C_s, then cophenetic
    correlation + dispersion of the consensus.

    Recommendation rule (stability + fit elbow): among candidates whose
    cophenetic correlation is within ``stability_tol`` of the best,
    start from the smallest and move to a larger stable candidate only
    while it improves the best-restart objective by at least
    ``cost_gain`` (relative).  Pure cophenetic argmax cannot separate
    NESTED stable clusterings (merging two true clusters the same way
    every restart is also perfectly stable); the fit elbow is the
    standard discriminator (Brunet 2004 choose-before-the-drop practice,
    Hutchins 2008 residual elbow).

    kwargs are forwarded to the solver (maxiter, seed, dtype, eps, ...).
    """
    cfg = merge_config(config, kwargs)
    cfg.setdefault("maxiter", 200)
    ranks = tuple(int(k) for k in ranks)
    if not ranks:
        raise ValueError("ranks must be a non-empty sequence")
    # Upload V once; the per-rank jnp.asarray inside nmf_multiseed is
    # then a no-op (a host transfer per candidate otherwise).
    V = jnp.asarray(V, resolve_dtype(V, cfg.get("dtype")))
    stats: list[RankStats] = []
    for k in ranks:
        res = nmf_multiseed(V, k, n_seeds, dict(cfg))
        labels = np.argmax(res.H, axis=1)                  # (S, n)
        conn = (labels[:, :, None] == labels[:, None, :])  # (S, n, n)
        consensus = conn.mean(axis=0)
        coph, disp = _consensus_metrics(consensus)
        final = res.cost[:, -1]
        stats.append(RankStats(rank=k, cophenetic=coph, dispersion=disp,
                               consensus=consensus,
                               mean_cost=float(np.mean(final)),
                               best_cost=float(np.min(final))))
    best = _recommend(ranks, stats, stability_tol, cost_gain)
    return RankSelection(recommended=ranks[best], ranks=ranks, stats=stats,
                         method="consensus")


def _recommend(ranks, stats, stability_tol: float, cost_gain: float) -> int:
    """Index of the recommended candidate (stability + fit elbow)."""
    order = sorted(range(len(ranks)), key=lambda i: ranks[i])
    max_coph = max(s.cophenetic for s in stats)
    stable = [i for i in order
              if stats[i].cophenetic >= max_coph - stability_tol]
    best = stable[0]
    floor = np.finfo(np.float64).tiny
    for i in stable[1:]:
        if 1.0 - stats[i].best_cost / max(stats[best].best_cost,
                                          floor) >= cost_gain:
            best = i
        else:
            # Stop at the first non-improving stable candidate: a gentle
            # monotone cost slope must not ratchet past the elbow by
            # accumulating sub-threshold gains across candidates.
            break
    return best


def pick_rank(V, ranks=None, method: str = "consensus", **kwargs):
    """Pick ``num_basis_elems`` for V.

    method="consensus" (default): stability sweep over ``ranks``
    (required) -> RankSelection.  method="svd": spectral-energy estimate
    (kwargs: energy, max_rank, seed) -> RankSelection with empty stats
    and the energy curve attached as ``.energy_curve``.
    """
    if method == "consensus":
        if ranks is None:
            raise ValueError("consensus rank selection needs candidate ranks")
        return consensus_stability(V, ranks, **kwargs)
    if method == "svd":
        rank, curve = estimate_rank_svd(V, **kwargs)
        sel = RankSelection(recommended=rank,
                            ranks=tuple(range(1, len(curve) + 1)),
                            stats=[], method="svd")
        sel.energy_curve = curve  # type: ignore[attr-defined]
        return sel
    raise ValueError(f"unknown rank-selection method {method!r}")
