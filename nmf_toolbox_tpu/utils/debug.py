"""Tracing, profiling, and numerical-debug helpers (SURVEY.md section 5).

The reference's only observability is the per-iteration cost vector and
two 'Algorithm converged' prints.  Here:

* ``trace(label)``: jax.profiler trace annotation context for solver
  calls (view with TensorBoard / xprof).
* ``profile_to(logdir)``: capture a device profile around a block.
* ``check_finite(result)``: post-hoc guard that factors and cost are
  finite — the debug-mode analog of the reference's eps-guard philosophy.
* ``iteration_logger()``: host callback printing the per-iteration cost
  from inside the on-device loop (opt-in; synchronizes every iteration).
"""
from __future__ import annotations

import contextlib

import numpy as np
import jax


def trace(label: str):
    """Profiler annotation: ``with trace('nmf'): nt.nmf(...)``."""
    return jax.profiler.TraceAnnotation(label)


@contextlib.contextmanager
def profile_to(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def check_finite(result) -> None:
    """Raise if any factor or the cost trace contains NaN/Inf."""
    for f in result.fields:
        val = getattr(result, f)
        arrs = val if isinstance(val, (list, tuple)) else [val]
        for a in arrs:
            if a is None:
                continue
            a = np.asarray(a)
            if not np.all(np.isfinite(a)):
                raise FloatingPointError(
                    f"non-finite values in result field '{f}'")


def iteration_logger(prefix: str = "iter"):
    """Returns a callback(iteration, cost) -> None suitable for wiring
    through jax.debug.callback from inside a solver step."""
    def cb(i, c):
        print(f"{prefix} {int(i) + 1}: cost = {float(c):.6e}")
    return cb


@contextlib.contextmanager
def emulate_tf32_matmul_numerics():
    """CPU-side emulation of GPU float32 matmul numerics at the default
    precision: TF32 tensor-core operands (10-bit mantissa, float32
    exponent range) with float32 accumulation.

    Inside the context, every float32 ``dot_general`` traced under jit
    at the default precision gets its operands rounded to TF32 with
    ``lax.reduce_precision`` -- the error model the card applies -- so
    golden-parity thresholds can be calibrated against the worse of
    {CPU-f32, CPU-TF32-matmul} without a GPU.  Elementwise ops stay
    float32, as on the card.  ``reduce_precision`` is an explicit op, so
    XLA keeps it whatever its excess-precision setting.

    Interception point: ``dot_general_p.bind_with_trace`` -- the one
    funnel every jnp matmul/einsum/@ passes through under tracing.  The
    rounding is bound through the same trace object so the rewrite
    composes with jit/scan/while_loop/vmap.  Complex64 dots are left
    untouched.  Emulation-only diagnostic: never use in the product
    path.
    """
    from jax._src.lax import lax as _lax
    prim = _lax.dot_general_p
    rp = _lax.reduce_precision_p
    orig = prim.bind_with_trace
    f32 = np.dtype("float32")

    def _round_tf32(trace, x):
        return rp.bind_with_trace(trace, (x,), dict(exponent_bits=8,
                                                   mantissa_bits=10))

    def _is_default_precision(p):
        if p is None:
            return True
        vals = p if isinstance(p, tuple) else (p,)
        return all(v in (None, jax.lax.Precision.DEFAULT) for v in vals)

    def bwt(trace, args, params):
        lhs, rhs = args
        # Explicitly raised precision (e.g. the nmfsc line search's
        # 'highest') runs in full float32 on the card too.
        if (getattr(lhs, "dtype", None) == f32
                and getattr(rhs, "dtype", None) == f32
                and _is_default_precision(params.get("precision"))):
            lhs = _round_tf32(trace, lhs)
            rhs = _round_tf32(trace, rhs)
        return orig(trace, (lhs, rhs), params)

    # jnp's ops are internally jit(inline=True)-wrapped and cache their
    # traced jaxprs by aval: a matmul shape traced before entry would
    # silently bypass the emulation, and one traced inside would leak
    # the rounding out after exit.  Flush on both edges.
    jax.clear_caches()
    prim.bind_with_trace = bwt
    try:
        yield
    finally:
        prim.bind_with_trace = orig
        jax.clear_caches()
