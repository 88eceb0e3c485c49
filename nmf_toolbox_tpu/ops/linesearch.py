"""Backtracking projected-gradient line search (nmfsc.m:152-179).

Shared by nmfsc and cnmfsc: trial step, project, accept when the
objective does not increase, halve otherwise, declare convergence when
the stepsize underflows 1e-200 (nmfsc.m:170-174), grow 1.2x on success
(nmfsc.m:178).  On underflow X is returned unchanged (MATLAB returns the
un-accepted factor).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import STEP_UNDERFLOW


def underflow_threshold(dtype) -> float:
    """Stepsize below which the search declares convergence.

    MATLAB's 1e-200 (nmfsc.m:170) assumes double precision; in float32
    1e-200 rounds to 0.0 and `step < 0.0` can never fire, so a search
    whose trials never accept (possible once fp noise in the objective
    exceeds the true decrease) halves the step to 0 and loops FOREVER —
    an infinite on-device while_loop, which float32 runs at the 5000x2000
    r50 BASELINE #2 shape did hit.  Clamp to the dtype's smallest normal
    instead; f64 semantics (reference parity) are unchanged since
    tiny(f64) < 1e-200.
    """
    return max(STEP_UNDERFLOW, float(np.finfo(np.dtype(dtype)).tiny))


def backtracking_search(obj_fn, X, dX, step0, project, begobj):
    """Returns (X_out, step_out, underflow, accepted_obj)."""
    dt = X.dtype
    under_thr = underflow_threshold(dt)

    def cond(carry):
        _, _, _, accepted, underflow = carry
        return (~accepted) & (~underflow)

    def body(carry):
        step, Xb, _, _, _ = carry
        Xnew = project(X - step * dX)
        newobj = obj_fn(Xnew)
        accepted = newobj <= begobj
        step_next = jnp.where(accepted, step, step / 2.0)
        underflow = (~accepted) & (step_next < under_thr)
        return step_next, jnp.where(accepted, Xnew, Xb), newobj, accepted, underflow

    step, Xn, obj, accepted, underflow = jax.lax.while_loop(
        cond, body, (jnp.asarray(step0, dt), X, jnp.zeros((), dt),
                     jnp.asarray(False), jnp.asarray(False)))
    X_out = jnp.where(accepted, Xn, X)
    step_out = jnp.where(accepted, 1.2 * step, step)
    return X_out, step_out, underflow, obj


def parallel_backtracking_search(obj_fn, X, dX, step0, project, begobj,
                                 width: int):
    """Batched backtracking: evaluate ``width`` successive halvings of the
    step in ONE vmapped projection + objective evaluation per round.

    Semantically identical to ``backtracking_search`` — the accepted
    candidate is the FIRST step in halving order whose objective does not
    increase, and an underflow that sequential halving would hit before
    reaching a later acceptable candidate still wins — but each round
    costs one batched evaluation instead of up to ``width`` sequential
    (projection, objective, halve) round-trips: the batch turns tiny
    sequential Gram-form evaluations into one wider program.
    """
    dt = X.dtype
    under_thr = underflow_threshold(dt)
    halv = (0.5 ** jnp.arange(width)).astype(dt)          # (J,)
    bshape = (-1,) + (1,) * X.ndim

    def round_body(carry):
        step, _, _, _, _ = carry      # step = first candidate this round
        steps = step * halv
        Xc = X[None] - steps.reshape(bshape) * dX[None]
        Xp = jax.vmap(project)(Xc)
        objs = jax.vmap(obj_fn)(Xp)
        acc = objs <= begobj
        any_acc = jnp.any(acc)
        j_acc = jnp.argmax(acc)       # first acceptable candidate
        under = (steps / 2.0) < under_thr
        any_und = jnp.any(under)
        j_und = jnp.argmax(under)     # first candidate whose halve underflows
        # sequential order: trial j_acc is evaluated (and accepted) before
        # its own halve-check, so acceptance wins ties; an underflow
        # strictly before the first acceptance preempts it.
        accepted = any_acc & ((~any_und) | (j_acc <= j_und))
        underflow = any_und & (~accepted)
        j = jnp.where(accepted, j_acc,
                      jnp.where(underflow, j_und, width - 1))
        X_out = jnp.where(accepted, Xp[j], X)
        step_out = jnp.where(
            accepted, 1.2 * steps[j],
            jnp.where(underflow, steps[j] / 2.0, steps[width - 1] / 2.0))
        return step_out, X_out, objs[j], accepted, underflow

    def cond(carry):
        _, _, _, accepted, underflow = carry
        return (~accepted) & (~underflow)

    step, Xn, obj, accepted, underflow = jax.lax.while_loop(
        cond, round_body, (jnp.asarray(step0, dt), X, jnp.zeros((), dt),
                           jnp.asarray(False), jnp.asarray(False)))
    return Xn, step, underflow, obj


def resolve_width(value, mesh=None) -> int:
    """Resolve the ``linesearch_width`` config knob to a concrete width.

    ``None`` / ``"auto"`` (the default when the knob is not set) selects
    parallel backtracking with width 8 when the solve will run on a GPU
    and the reference sequential halving elsewhere (the batch evaluates
    every candidate even when the first accepts, which can lose on CPU).
    On an H100 (700 W limit), ``nt.nmfsc`` at 5000x2000 r50 Hoyer 0.6
    took a median 2.41 ms/iter at width 8 against 2.64 ms/iter at width
    0 over 100-iteration runs, and 6.54 against 7.38 over 30-iteration
    runs (benchmarks/linesearch_width.py).  An integer forces that width
    (0 = sequential halving).

    Equivalence: the batched search takes the same accept/halve/underflow
    decisions as sequential halving (cost trace and stepsize state
    bit-identical; exact on CPU).  On a GPU the accepted factors can
    differ at fp reduction-order scale (the cost traces of widths 0 and 8
    differed by 1.1e-6 relative over 100 iterations on an H100) because
    the vmapped trial evaluation accumulates matmuls in a different
    order; pass ``linesearch_width=0`` for the exactly
    sequential evaluation order.

    ``mesh``: when the solve is sharded, the mesh's devices decide the
    platform; otherwise ``jax.default_backend()`` does.

    Scope: the fused (single-program) nmfsc/cnmfsc solvers, where the
    batched round removes sequential on-device trial evaluations.  The
    phased nmfsc dispatch resolves None/'auto' to sequential instead —
    it is host-round-trip-dominated (models/nmfsc_phased.py).
    """
    if value is None or (isinstance(value, str) and value == "auto"):
        if mesh is not None:
            platform = next(iter(mesh.devices.flat)).platform
        else:
            platform = jax.default_backend()
        return 8 if platform == "gpu" else 0
    return int(value)


def make_search(width: int):
    """Search-function factory: 0 = reference sequential halving,
    >0 = parallel backtracking with that batch width."""
    if width <= 0:
        return backtracking_search

    def search(obj_fn, X, dX, step0, project, begobj):
        return parallel_backtracking_search(obj_fn, X, dX, step0, project,
                                            begobj, width)
    return search
