"""Initialization recipes that live off the hot path.

The reference leans on MATLAB toolbox built-ins for some inits:
kmeans for the semi/convex family's indicator H (ValidateParameters.m:45-54,
seminmf.m:109-117) and cov/eig/convhull for the convex-hull family's
anchor points (chnmf.m:85-106).  Here:

* k-means runs fully on device (kmeans++ seeding + Lloyd iterations in a
  ``lax.while_loop``) — no host round trip, works under jit.
* hull extraction computes the top principal directions on device
  (exact eigh for small m, randomized subspace iteration for large m so
  the m-by-m covariance of chnmf.m:90 is never materialized), then runs a
  2-D monotone-chain convex hull on host per eigenvector pair (one-time,
  data-dependent output size — SURVEY.md section 7 "Hard parts").
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# k-means (device)
# ---------------------------------------------------------------------------

def kmeans(key, X, k: int, *, maxiter: int = 100, tol: float = 1e-6):
    """Lloyd's k-means on rows of X (n, d) with kmeans++ seeding.

    Returns (labels (n,), centers (k, d)).  Replaces the Statistics-Toolbox
    ``kmeans`` used at ValidateParameters.m:48 / seminmf.m:111.
    """
    X = jnp.asarray(X)
    n, d = X.shape
    x_sq = jnp.sum(X * X, axis=1)

    # -- kmeans++ seeding ---------------------------------------------------
    # Running-minimum formulation: each step computes distances to the
    # ONE newest center and folds them into dmin — O(k n d) total instead
    # of the O(k^2 n d) of re-evaluating all centers per step (at
    # 10k x 100k with k = 200 that is the difference between ~0.4 s and
    # ~400 s of seeding).
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, n)
    centers0 = jnp.zeros((k, d), X.dtype).at[0].set(X[first])

    def seed_body(i, carry):
        centers, dmin, key = carry
        c = centers[i - 1]  # the center picked in the previous step
        d_new = jnp.maximum(x_sq - 2.0 * (X @ c) + jnp.sum(c * c), 0.0)
        dmin = jnp.minimum(dmin, d_new)
        key, sub = jax.random.split(key)
        total = jnp.sum(dmin)
        probs = jnp.where(total > 0, dmin / total, jnp.ones_like(dmin) / n)
        idx = jax.random.choice(sub, n, p=probs)
        return centers.at[i].set(X[idx]), dmin, key

    dmin0 = jnp.full((n,), jnp.inf, X.dtype)
    centers, _, key = jax.lax.fori_loop(1, k, seed_body,
                                        (centers0, dmin0, key))

    # -- Lloyd iterations ---------------------------------------------------
    def assign(centers):
        dists = x_sq[:, None] - 2.0 * X @ centers.T + jnp.sum(centers**2, axis=1)[None, :]
        return jnp.argmin(dists, axis=1)

    def cond(carry):
        _, _, it, moved = carry
        return (it < maxiter) & moved

    def body(carry):
        centers, labels, it, _ = carry
        onehot = (labels[:, None] == jnp.arange(k)[None, :]).astype(X.dtype)
        counts = jnp.sum(onehot, axis=0)
        sums = onehot.T @ X
        new_centers = jnp.where(counts[:, None] > 0,
                                sums / jnp.maximum(counts[:, None], 1.0),
                                centers)
        new_labels = assign(new_centers)
        moved = jnp.max(jnp.sum((new_centers - centers) ** 2, axis=1)) > tol
        return new_centers, new_labels, it + 1, moved

    labels = assign(centers)
    centers, labels, _, _ = jax.lax.while_loop(
        cond, body, (centers, labels, jnp.int32(0), jnp.asarray(True)))
    return labels, centers


def kmeans_indicator_h(key, V, k: int, dtype, offset: float = 0.2):
    """Indicator-matrix H init: H[c_j, j] = 1, then + offset.

    Reference: ValidateParameters.m:45-54 / seminmf.m:109-117 (the
    reference has a missing-{i} cell bug at ValidateParameters.m:51; this
    is the intended behavior).
    """
    labels, _ = kmeans(key, jnp.asarray(V, dtype).T, k)
    H = (labels[None, :] == jnp.arange(k)[:, None]).astype(dtype)
    return H + jnp.asarray(offset, dtype)


# ---------------------------------------------------------------------------
# NNDSVD (Boutsidis & Gallopoulos 2008) — beyond-reference extra init
# ---------------------------------------------------------------------------

def seedable(V):
    """Zero-fill NaN before seeding (NNDSVD/kmeans): NaN may legitimately
    sit at zero-weight entries of a weighted problem (API.md 'weights'),
    and the seeding algorithms would otherwise silently return all-NaN
    factors."""
    import jax.numpy as jnp
    return jnp.where(jnp.isnan(V), 0.0, V)


def _working_eps(dtype):
    """Machine epsilon of the operand dtype (ADVICE r2: f64 NNDSVD runs
    should use ~1e-16 ridges/floors, not the f32 ~1e-7).  Low-precision
    dtypes (bf16/f16) fall back to float32 eps — their accumulations
    happen in f32 on the device and a 1e-2-scale ridge would wreck the Gram."""
    eps = np.finfo(np.dtype(dtype)).eps if np.issubdtype(
        np.dtype(dtype), np.floating) else np.finfo(np.float32).eps
    return min(float(eps), float(np.finfo(np.float32).eps))


def _cholesky_qr(A, eps):
    """Orthonormalize the columns of a tall-skinny A via Cholesky-QR.

    One k-by-k Gram + triangular solve instead of Householder QR: the
    Gram is one matmul, while a Householder QR of a (100k, 200) operand
    is a long chain of narrow panel updates.  Squares the condition
    number — fine for the randomized-SVD power iterations, which
    re-orthogonalize repeatedly.

    Robustness: columns are pre-normalized (scaling does not change the
    span) so the Gram has a unit diagonal, and a k*eps ridge keeps the
    Cholesky positive-definite even for exactly rank-deficient sketches
    (e.g. duplicated-row inputs) — without this the factor goes NaN and
    poisons everything downstream.
    """
    tiny = jnp.asarray(np.finfo(np.float32).tiny, A.dtype)
    norms = jnp.sqrt(jnp.sum(A * A, axis=0))
    A = A / jnp.maximum(norms, tiny)[None, :]
    G = jax.lax.dot_general(A, A, (((0,), (0,)), ((), ())),
                            preferred_element_type=A.dtype)
    k = G.shape[0]
    G = G + (k * eps) * jnp.eye(k, dtype=A.dtype)
    R = jnp.linalg.cholesky(G, upper=True)
    return jax.scipy.linalg.solve_triangular(R.T, A.T, lower=True).T


def _randomized_svd(key, V, k: int, oversample: int = 10,
                    power_iters: int = 2):
    """Truncated randomized SVD (Halko et al. 2011), fully on device.

    The m-by-n input is touched only through matmuls; the dense
    decompositions run on (p, p) Grams of the (m|n, p) sketches
    (Cholesky-QR + eigh instead of QR/SVD of the tall operands).  Power
    iterations with re-orthogonalization sharpen the spectrum enough for an
    *initialization* (this is not a certified SVD).
    """
    m, n = V.shape
    p = int(min(k + oversample, m, n))
    eps = jnp.asarray(_working_eps(V.dtype), V.dtype)
    Om = jax.random.normal(key, (n, p), V.dtype)
    Q = _cholesky_qr(V @ Om, eps)
    for _ in range(power_iters):
        Z = _cholesky_qr(V.T @ Q, eps)
        Q = _cholesky_qr(V @ Z, eps)
    B = Q.T @ V                                   # (p, n)
    # SVD of B from the (p, p) eigendecomposition of B B'.
    M = jax.lax.dot_general(B, B, (((1,), (1,)), ((), ())),
                            preferred_element_type=B.dtype)
    vals, Ub = jnp.linalg.eigh(M)                 # ascending
    vals, Ub = vals[::-1], Ub[:, ::-1]
    s = jnp.sqrt(jnp.maximum(vals, 0.0))
    Vt = (Ub.T @ B) / jnp.maximum(s, eps * jnp.max(s))[:, None]
    return (Q @ Ub)[:, :k], s[:k], Vt[:k, :]


def nndsvd(V, k: int, *, key=None, variant: str = "nndsvdar",
           dtype=None, oversample: int = 10, power_iters: int = 2):
    """Nonnegative Double SVD initialization: (W0, H0) for V ~ W @ H.

    A beyond-the-reference extra (the reference only offers uniform
    random init): NNDSVD seeds the factors from the sign-split leading
    singular triplets, which typically cuts the iterations-to-tolerance
    of both MU (models/nmf.py) and HALS (models/hals.py) severalfold.

    variants (zeros are absorbing states for multiplicative updates):
      'nndsvd'    exact sign-split factors; keeps hard zeros
      'nndsvda'   zeros replaced with mean(V)
      'nndsvdar'  zeros replaced with uniform(0, mean(V)/100)  [default]
    """
    if variant not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown NNDSVD variant {variant!r}")
    V = jnp.asarray(V, dtype)
    if k > min(V.shape):
        # the randomized sketch is capped at min(m, n) columns; silently
        # returning fewer than k components would corrupt callers
        raise ValueError(
            f"NNDSVD needs k <= min(V.shape) = {min(V.shape)}, got k = {k}")
    if key is None:
        key = jax.random.PRNGKey(0)
    ks, kw, kh = jax.random.split(key, 3)
    U, s, Vt = _randomized_svd(ks, V, k, oversample, power_iters)
    tiny = jnp.asarray(np.finfo(np.asarray(s).dtype).tiny, V.dtype)

    # Leading triplet: nonnegative up to sign (Perron-Frobenius for
    # nonnegative V); abs() fixes the SVD's sign ambiguity.
    w0 = jnp.sqrt(s[0]) * jnp.abs(U[:, 0])
    h0 = jnp.sqrt(s[0]) * jnp.abs(Vt[0, :])

    # Remaining triplets, vectorized over j: keep the dominant
    # sign-consistent half of each rank-1 term.
    Uj, Vj = U[:, 1:], Vt[1:, :]
    up, un = jnp.maximum(Uj, 0.0), jnp.maximum(-Uj, 0.0)
    vp, vn = jnp.maximum(Vj, 0.0), jnp.maximum(-Vj, 0.0)
    upn = jnp.sqrt(jnp.sum(up * up, axis=0))
    unn = jnp.sqrt(jnp.sum(un * un, axis=0))
    vpn = jnp.sqrt(jnp.sum(vp * vp, axis=1))
    vnn = jnp.sqrt(jnp.sum(vn * vn, axis=1))
    mp, mn_ = upn * vpn, unn * vnn
    use_p = mp >= mn_
    u = jnp.where(use_p[None, :], up / jnp.maximum(upn, tiny)[None, :],
                  un / jnp.maximum(unn, tiny)[None, :])
    v = jnp.where(use_p[:, None], vp / jnp.maximum(vpn, tiny)[:, None],
                  vn / jnp.maximum(vnn, tiny)[:, None])
    sig = jnp.sqrt(s[1:] * jnp.where(use_p, mp, mn_))
    W = jnp.concatenate([w0[:, None], u * sig[None, :]], axis=1)
    H = jnp.concatenate([h0[None, :], v * sig[:, None]], axis=0)

    if variant != "nndsvd":
        vmean = jnp.mean(V)
        if variant == "nndsvda":
            fw = fh = vmean
        else:  # nndsvdar
            fw = jax.random.uniform(kw, W.shape, W.dtype) * (vmean / 100.0)
            fh = jax.random.uniform(kh, H.shape, H.dtype) * (vmean / 100.0)
        W = jnp.where(W > 0, W, fw)
        H = jnp.where(H > 0, H, fh)
    return W, H


# ---------------------------------------------------------------------------
# Convex-hull anchor extraction (chnmf.m:85-106 / chcnmf.m:96-120)
# ---------------------------------------------------------------------------

def _top_eigvecs_exact(Vc):
    """Exact covariance eigendecomposition for small m (chnmf.m:90-93)."""
    C = jnp.cov(Vc)  # (m, m), rows are variables — matches MATLAB cov(V')
    vals, vecs = jnp.linalg.eigh(C)
    order = jnp.argsort(vals)[::-1]
    return vals[order], vecs[:, order]


@functools.partial(jax.jit, static_argnums=(1, 3))
def _randomized_spectrum(V, num: int, seed, iters: int):
    """One compiled program: randomized subspace iteration for the top
    eigenpairs of cov(V') PLUS the Hutchinson estimate of ||cov||_F^2.

    Never materializes the m-by-m covariance (only cov @ Q products);
    Cholesky-QR instead of tall-skinny Householder QR (same choice as
    _randomized_svd), and
    a single jit so the centered V is materialized once instead of per
    eager op (the eager version spent ~7 s re-deriving it for the probe).
    """
    n = V.shape[1]
    mean = jnp.mean(V, axis=1, keepdims=True)
    Vc = V - mean
    eps = jnp.asarray(_working_eps(V.dtype), V.dtype)
    key = jax.random.PRNGKey(seed)

    def matvec_c(Q):
        return Vc @ (Vc.T @ Q) / (n - 1.0)

    Q = jax.random.normal(key, (V.shape[0], num), V.dtype)
    for _ in range(iters):
        Q = _cholesky_qr(matvec_c(Q), eps)
    B = Q.T @ matvec_c(Q)
    vals, S = jnp.linalg.eigh(B)
    order = jnp.argsort(vals)[::-1]
    Z = jax.random.normal(jax.random.PRNGKey(seed + 1), (V.shape[0], 8),
                          V.dtype)
    CZ = matvec_c(Z)
    total_sq = jnp.mean(jnp.sum(CZ * CZ, axis=0))
    return vals[order], (Q @ S)[:, order], total_sq




def _convhull_2d(points: np.ndarray) -> np.ndarray:
    """Indices of the 2-D convex hull (Andrew's monotone chain), host-side.

    Replaces MATLAB convhull (chnmf.m:100).  Uses the native C++ chain
    (native/nmf_native.cpp) when the toolchain is available — the hull
    runs once per eigenvector pair over the full sample cloud, which is
    Python-loop-bound at large n.
    """
    # Non-finite coordinates (upstream numerical failure) must never
    # reach the native code: a monotone chain over NaN comparisons can
    # write past its output buffer (observed as heap corruption).
    finite = np.isfinite(points).all(axis=1)
    if not finite.all():
        keep_idx = np.nonzero(finite)[0]
        if keep_idx.size == 0:
            return np.empty((0,), dtype=np.int64)
        sub = _convhull_2d(points[keep_idx])
        return keep_idx[sub]
    from .. import native
    idx = native.convhull2d(points)
    if idx is not None:
        return idx
    order = np.lexsort((points[:, 1], points[:, 0]))

    def half(idx_iter):
        hull = []
        for i in idx_iter:
            while len(hull) >= 2:
                o, a = points[hull[-2]], points[hull[-1]]
                if (a[0] - o[0]) * (points[i][1] - o[1]) - (a[1] - o[1]) * (points[i][0] - o[0]) <= 0:
                    hull.pop()
                else:
                    break
            hull.append(i)
        return hull

    lower = half(order)
    upper = half(order[::-1])
    return np.unique(np.array(lower[:-1] + upper[:-1], dtype=np.int64))


def convex_hull_anchors(V, pct_eigval_energy: float = 0.95,
                        max_eigvecs: int = 16, seed: int = 0) -> jax.Array:
    """Extract hull anchor columns S of V (chnmf.m:85-106).

    Keeps the top-E principal directions covering ``pct_eigval_energy`` of
    the squared-eigenvalue energy (min 2, chnmf.m:94-95), projects V onto
    each eigenvector pair, takes the 2-D convex hull, and collects the
    corresponding (deduplicated) columns of V.

    One-time host-synced init; returns an (m, p) DEVICE array (column
    count p is data-dependent).  Only small intermediates cross the
    host boundary (the (n, keep) projections for the host-side hulls and
    a row-head of S for ordering) — the (m, p) anchor matrix itself never
    leaves the device (at 100k x 10k S is 216 MB).
    """
    V = jnp.asarray(V)
    m, n = V.shape
    if m == 1:  # chnmf.m:87-89
        return jnp.asarray([[float(jnp.min(V)), float(jnp.max(V))]],
                           V.dtype)
    if n <= 2:  # chcnmf.m:101-102
        return V

    num_request = int(min(max_eigvecs, m, n - 1 if n > 1 else 1))
    if m <= 1024:
        # Exact path: the energy rule of chnmf.m:94-95 runs over the FULL
        # spectrum, exactly like the reference.
        vals_d, vecs = _top_eigvecs_exact(V)
        total_sq = float(jnp.sum(vals_d ** 2))
    else:
        # Randomized path: top eigenpairs only; estimate the full-spectrum
        # energy sum(lambda_i^2) = ||C||_F^2 with a Hutchinson probe
        # (||C z||^2 averaged over gaussian z) so the threshold rule sees
        # the same denominator as the reference without the m-by-m
        # covariance.
        vals_d, vecs, tsq = _randomized_spectrum(V, int(num_request),
                                                 int(seed), 4)
        total_sq = float(tsq)
    vals = np.asarray(vals_d)  # (num,) tiny transfer

    # num_eigvals_keep: first index where cumulative squared-eigenvalue
    # energy exceeds the threshold (chnmf.m:94-95), at least 2; on the
    # randomized path capped at the computed subspace (max_eigvecs).
    sq = vals ** 2
    cum = np.cumsum(sq) / max(total_sq, np.finfo(vals.dtype).tiny)
    above = np.nonzero(cum > pct_eigval_energy)[0]
    keep = int(above[0] + 1) if above.size else vals.shape[0]
    keep = max(keep, 2)
    keep = min(keep, vals.shape[0])

    # (n, keep) projections — computed on device, small host transfer.
    proj_all = np.asarray(jax.lax.dot_general(
        V, vecs[:, :keep], (((0,), (0,)), ((), ()))))
    idx_set: set[int] = set()
    for e1 in range(keep - 1):
        for e2 in range(e1 + 1, keep):
            idx = _convhull_2d(proj_all[:, [e1, e2]])
            idx_set.update(int(i) for i in idx)
    # Dedupe on column INDICES rather than column values (identical
    # anchor set unless V contains duplicate columns at different
    # indices, and O(p log p) ints instead of sorting p rows of length
    # m), then restore the value-lexicographic column ORDER that the
    # reference's unique(S', 'rows') produces (chnmf.m:102) so default
    # G_init pairing matches.  The lexsort keys come from a row-HEAD of
    # S (tiny transfer); exact ties within the head fall back to the
    # full matrix so the order always matches the full lexsort.
    cols = np.fromiter(sorted(idx_set), dtype=np.int64)
    S_dev = V[:, jnp.asarray(cols)]
    head = np.asarray(S_dev[: min(m, 64)])
    if np.unique(head.T, axis=0).shape[0] < head.shape[1]:
        head = np.asarray(S_dev)  # tied heads: order on full columns
    order = np.lexsort(head[::-1, :])  # primary key = first row
    return S_dev[:, jnp.asarray(order)]
