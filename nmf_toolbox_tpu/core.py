"""Core utilities: parameter validation, result containers, RNG init.

This is the single config/validation path replacing the six divergent
``ValidateParameters`` implementations in the reference toolbox
(reference: ValidateParameters.m, nmf.m:238-413, cnmf.m:271-449,
lnmf.m:96-136, seminmf.m:99-144, plus the inline defaulting in
nmfsc.m:67-130 / chnmf.m:71-167).

Multi-source semantics (reference: nmf.m:114-117, 228-234): a solver
accepts ``num_basis_elems`` as an int (one source; factors returned as
plain arrays) or a sequence of ints (K sources; factors returned as
lists).  Internally sources are concatenated: W is (m, k_total) with
source s occupying a static column block, H is (k_total, n) with the
matching row block.  Per-source scalars (sparsity) are promoted to
per-column / per-row vectors, so the hot loop has no per-source logic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import jax
import jax.numpy as jnp

# MATLAB double eps (reference uses `eps` as the division guard in every
# multiplicative update, e.g. nmf.m:168,199).
EPS = float(np.finfo(np.float64).eps)  # 2.220446049250313e-16

# Stepsize underflow threshold for projected-gradient line searches
# (reference: nmfsc.m:170,221; cnmfsc.m:190,245).
STEP_UNDERFLOW = 1e-200


def common_scalars(cfg) -> tuple:
    """(maxiter, tolerance, eps, key): the scalar config every solver
    shares, with the reference's invalid-value fallbacks
    (ValidateParameters.m:222-230)."""
    maxiter = int(cfg.get("maxiter", 100) or 100)
    if maxiter <= 0:
        maxiter = 100
    tolerance = float(cfg.get("tolerance", 1e-3))
    if tolerance <= 0:
        tolerance = 1e-3
    eps = float(cfg.get("eps", EPS))
    key = jax.random.PRNGKey(int(cfg.get("seed", 0)))
    return maxiter, tolerance, eps, key


def parse_cost_every(cfg) -> int:
    """``cost_every`` config key (objective cadence, beyond-reference):
    evaluate the objective every N iterations instead of every one.  The
    objective feeds only the stopping rule (nmf.m:221-224), never the
    multiplicative updates, so the factor trajectory is bit-identical at
    any cadence; see ops/loop.cost_cadence."""
    ce = cfg.get("cost_every", 1)
    ce = 1 if ce is None else int(ce)
    if ce < 1:
        raise ValueError("cost_every must be >= 1")
    return ce


def resolve_dtype(V, dtype):
    """Pick the compute dtype: explicit override > input dtype > float32."""
    if dtype is not None:
        return jnp.dtype(dtype)
    d = np.asarray(V).dtype if not isinstance(V, jax.Array) else V.dtype
    if d in (np.float64, np.complex128) and not jax.config.jax_enable_x64:
        # x64 disabled: JAX would silently downcast anyway.
        return jnp.dtype(np.complex64) if d == np.complex128 else jnp.dtype(np.float32)
    if np.issubdtype(d, np.floating) or np.issubdtype(d, np.complexfloating):
        return jnp.dtype(d)
    return jnp.dtype(np.float32)


def ingest_rescaled(V, dtype, errmsg: str = "Negative values in data!"):
    """nmfsc-family V ingestion: cast/upload ONCE, then check
    nonnegativity and rescale by the global max (nmfsc.m:57-62) with
    scalar-only host readbacks.

    A device-resident V is never round-tripped through the host (an
    ``np.asarray(V)`` path would cost two full-matrix transfers per
    call); for repeated solves, pass ``jnp.asarray(V)`` once and reuse.

    The checks run in the COMPUTE dtype: a negative f64 entry below the
    f32 subnormal range rounds to -0.0 under dtype=float32 and passes
    (it is exactly zero in compute precision), and the rescale divides
    after the cast (ulp-level difference vs divide-then-cast for
    mixed-precision inputs).  Same-precision inputs are unaffected.
    """
    Vd = jnp.asarray(V, dtype)
    ext = np.asarray(jnp.stack([jnp.min(Vd), jnp.max(Vd)]))  # one readback
    if float(ext[0]) < 0:
        raise ValueError(errmsg)
    return Vd / jnp.asarray(ext[1], dtype)


def real_dtype_of(dtype):
    # Pure host-side dtype arithmetic: no device scalar, no dispatch.
    return jnp.dtype(np.finfo(np.dtype(dtype)).dtype)


def to_host(x):
    """Device -> NumPy, complex-safe: fetch real/imag planes and
    recombine on the host, so only real buffers cross the boundary (the
    convention every complex solver keeps, models/cmfwisa.py)."""
    if x is None or isinstance(x, np.ndarray):
        return x
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return np.asarray(jnp.real(x)) + 1j * np.asarray(jnp.imag(x))
    return np.asarray(x)


def as_list(x) -> tuple[list, bool]:
    """Normalize scalar-or-sequence to a list; report whether it was a sequence.

    Mirrors the cell-array promotion of the reference (nmf.m:114-116,
    ValidateParameters.m:130-220).
    """
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def promote_per_source(value, num_sources: int, name: str, default):
    """Promote a scalar-or-list config value to a per-source list.

    Reference: ValidateParameters.m:130-220 (scalar -> cell promotion and
    count validation).
    """
    if value is None:
        value = default
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if len(vals) == 1:
            vals = vals * num_sources
        if len(vals) != num_sources:
            raise ValueError(
                f"Requested {num_sources} sources. Given {len(vals)} {name} values."
            )
        return vals
    return [value] * num_sources


def promote_inits(inits, num_sources: int, name: str) -> tuple[list | None, bool]:
    """Normalize user-supplied factor inits to a per-source list (or None).

    Returns (list_or_none, was_sequence).  Reference:
    ValidateParameters.m:33-66 / nmf.m:269-309.
    """
    if inits is None:
        return None, num_sources > 1
    if isinstance(inits, (list, tuple)):
        if len(inits) != num_sources:
            raise ValueError(
                f"Requested {num_sources} sources. Given {len(inits)} initial {name} matrices."
            )
        return [np.asarray(a) for a in inits], True
    return [np.asarray(inits)], False


def source_blocks(ks: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """Static (start, stop) column blocks for each source in concatenated W/H."""
    out, off = [], 0
    for k in ks:
        out.append((off, off + int(k)))
        off += int(k)
    return tuple(out)


def per_column(values: Sequence[float], ks: Sequence[int], dtype) -> jnp.ndarray:
    """Expand per-source scalars to a per-column (length sum(ks)) vector."""
    return jnp.concatenate(
        [jnp.full((int(k),), float(v), dtype=dtype) for v, k in zip(values, ks)]
    )


def fixed_col_mask(fixed: Sequence[bool], ks: Sequence[int]) -> np.ndarray:
    """Boolean mask (length sum(ks)): True where the source's factor is frozen."""
    return np.concatenate(
        [np.full((int(k),), bool(f)) for f, k in zip(fixed, ks)]
    )


# ---------------------------------------------------------------------------
# Random initialization (reference inits use MATLAB rand(); we use
# jax.random with an explicit seed.  Parity tests always inject inits —
# SURVEY.md section 7 "MATLAB parity without MATLAB RNG".)
# ---------------------------------------------------------------------------

def uniform_init(key, shape, dtype, floor_eps: bool = True):
    """max(rand(shape), eps) — reference ValidateParameters.m:43,79."""
    x = jax.random.uniform(key, shape, dtype=real_dtype_of(dtype))
    if floor_eps:
        x = jnp.maximum(x, jnp.asarray(EPS, x.dtype))
    return x.astype(dtype)


def default_w_init(key, m, ks, dtype, normalize=True):
    """Per-source random W, unit-L2 columns (ValidateParameters.m:79-81)."""
    keys = jax.random.split(key, len(ks))
    ws = []
    for kk, k in zip(keys, ks):
        w = uniform_init(kk, (m, int(k)), dtype)
        if normalize:
            w = w / jnp.sqrt(jnp.sum(w * w, axis=0, keepdims=True))
        ws.append(w)
    return ws


def default_h_init(key, ks, n, dtype):
    """Per-source random H (ValidateParameters.m:43)."""
    keys = jax.random.split(key, len(ks))
    return [uniform_init(kk, (int(k), n), dtype) for kk, k in zip(keys, ks)]


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    """Solver output.  Tuple-unpacks in the reference's output order, so
    ``W, H, cost = nmf(...)`` works exactly like the MATLAB call
    ``[W, H, cost] = nmf(...)`` (nmf.m:1)."""

    fields: tuple[str, ...]
    W: Any = None
    H: Any = None
    cost: Any = None
    P: Any = None
    G: Any = None
    S: Any = None
    Z: Any = None
    A: Any = None
    n_iters: int = 0
    converged: bool = False
    # Projected-gradient solver state beyond the factors (line-search
    # stepsizes, nmfsc.m:147,178): pass back via ``resume_state=`` for
    # bit-exact chunked continuation.  None for memoryless MU solvers.
    resume_state: Any = None

    def __iter__(self):
        return iter(getattr(self, f) for f in self.fields)

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i):
        return getattr(self, self.fields[i])

    @property
    def final_cost(self) -> float:
        """Last valid cost entry, robust to per-solver trace semantics
        (initial-cost offset traces have length n_iters+1; lnmf's
        untrimmed trace is zero-padded past n_iters).  For the batched
        engines' (B, iters) traces this is the BEST problem's final
        cost (the min over the batch at the last iteration) — the
        scalar a multi-restart caller actually wants; use ``cost[:, -1]``
        for the per-problem values."""
        c = np.asarray(self.cost)
        if c.ndim == 2:
            return float(np.min(c[:, -1]))
        n = int(self.n_iters)
        if len(c) in (n, n + 1) or n == 0:
            return float(c[-1])
        return float(c[max(n - 1, 0)])


def unwrap_sources(arr, blocks, axis: int, was_seq: bool):
    """Split a concatenated factor back into per-source arrays; return a
    plain array when the caller passed a scalar source spec
    (reference: nmf.m:228-234)."""
    parts = []
    for (a, b) in blocks:
        idx = (slice(None),) * axis + (slice(a, b),)
        parts.append(np.asarray(arr[idx]))
    if not was_seq:
        return parts[0]
    return parts


def merge_config(config, kwargs) -> dict:
    """Merge a MATLAB-style config dict with keyword overrides."""
    out = dict(config or {})
    out.update({k: v for k, v in kwargs.items() if v is not None})
    return out
