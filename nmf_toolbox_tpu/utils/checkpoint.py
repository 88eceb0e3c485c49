"""Factor checkpoint/resume.

The reference has no checkpoint subsystem, but its API is
checkpoint-friendly by construction: every solver accepts
``W_init``/``H_init`` (+ P/G/S/Z) and ``*_fixed`` switches, so resume is
re-calling the solver with the last factors (SURVEY.md section 5).  This
module adds the missing persistence: save a solver Result (or any dict of
factor arrays) to one ``.npz`` file and restore it as a kwargs dict ready
to splat back into the solver.

    res = nt.nmf(V, 20, maxiter=50)
    save_factors("ckpt.npz", res)
    ...
    res2 = nt.nmf(V, 20, maxiter=50, **load_factors("ckpt.npz"))
"""
from __future__ import annotations

import os

import numpy as np

_FACTOR_KEYS = ("W", "H", "P", "G", "S", "Z")


def _multiprocess_active() -> bool:
    # Inspect jax.distributed's own state rather than calling
    # jax.process_count(): process_count() forces backend init, and a
    # pure host-side npz save must never touch the backend.  Multi-process
    # runs always go through jax.distributed.initialize, which is what
    # sets this state.  The module is private; if a jax upgrade moves
    # it, fall through to "not multi-process" rather than breaking
    # every single-host save.
    try:
        from jax._src import distributed as _jdist
        _state = getattr(_jdist, "global_state", None)
    except (ImportError, AttributeError):
        return False
    return bool(_state is not None
                and (getattr(_state, "num_processes", None) or 1) > 1)


def _check_npz_saveable(name, val) -> None:
    # Under jax.distributed, np.asarray on a cross-process sharded
    # factor raises a cryptic non-addressable error (and a "working"
    # gather would still write data only this process holds).  Plain
    # numpy / fully-addressable (replicated or single-host) leaves are
    # fine — the standard "gather to host, save on process 0" pattern
    # must keep working.
    if not getattr(val, "is_fully_addressable", True):
        raise RuntimeError(
            f"factor {name!r} is sharded across processes; the npz "
            "checkpoint backend is single-host only — use "
            "save_factors_orbax / load_factors_orbax (per-shard "
            "writes, coordinated commit across processes) — "
            "utils/checkpoint_orbax.py")


def save_factors(path, result_or_dict, extra: dict | None = None) -> None:
    """Persist a Result's factors (and cost trace) to ``path`` (.npz)."""
    check = _check_npz_saveable if _multiprocess_active() else None
    payload = {}
    obj = result_or_dict
    if hasattr(obj, "fields"):  # core.Result
        items = {f: getattr(obj, f) for f in obj.fields}
        payload["__fields__"] = np.asarray(list(obj.fields))
        payload["__n_iters__"] = np.asarray(obj.n_iters)
    else:
        items = dict(obj)
    for name, val in items.items():
        if val is None:
            continue
        if isinstance(val, (list, tuple)):  # multi-source factors
            payload[f"{name}__len"] = np.asarray(len(val))
            for s, v in enumerate(val):
                if check:
                    check(name, v)
                payload[f"{name}__{s}"] = np.asarray(v)
        else:
            if check:
                check(name, val)
            payload[name] = np.asarray(val)
    if extra:
        for kk, vv in extra.items():
            if check:
                check(kk, vv)
            payload[f"extra__{kk}"] = np.asarray(vv)
    np.savez(path, **payload)


def load_factors(path, as_inits: bool = True) -> dict:
    """Load a checkpoint.  With ``as_inits`` (default) factor arrays are
    returned under their ``*_init`` kwarg names so the dict can be passed
    straight back into a solver; cost/aux entries are dropped."""
    with np.load(path, allow_pickle=False) as z:
        raw: dict = {}
        lens = {k[: -len("__len")]: int(z[k]) for k in z.files
                if k.endswith("__len")}
        for name, count in lens.items():
            raw[name] = [z[f"{name}__{s}"] for s in range(count)]
        for k in z.files:
            if k.startswith("extra__"):
                raw[k] = z[k]
                continue
            if ("__" in k) or k in raw:  # per-source parts + metadata
                continue
            raw[k] = z[k]
    if not as_inits:
        return raw
    out = {}
    for name in _FACTOR_KEYS:
        if name in raw:
            out[f"{name}_init"] = raw[name]
    return out


def run_checkpointed(solver, V, *args, total_iters: int, chunk: int,
                     path, resume: bool = True, backend: str = "auto",
                     **config):
    """Long-run driver: execute ``solver`` in chunks of ``chunk``
    iterations, persisting the factors after every chunk so a crashed run
    resumes where it left off (SURVEY.md section 5 failure-recovery plan).

    For the memoryless MU solvers (nmf, lnmf, cnmf, seminmf, convexnmf,
    chnmf, chcnmf, cmfwisa, constrainednmf, plain nmf_hals) the restart
    state equals the continuation state, so the resumed factors are
    IDENTICAL to an uninterrupted run (tested).  Solvers with state
    beyond the factors — nmfsc/cnmfsc line-search stepsizes
    (nmfsc.m:147,178; cnmfsc.m:147 per-frame vector) and extrapolated
    HALS momentum (Wy/Hy/beta) — thread it through
    ``Result.resume_state`` / the solvers' ``resume_state=`` config key,
    persisted in the checkpoint, so chunked runs are BIT-IDENTICAL to
    single-dispatch for these too (tested).

    The tolerance rule is additionally evaluated on the host across
    chunk boundaries (each chunk's device loop only compares within the
    chunk), so early stopping behaves with any chunk size.  Returns the
    final Result with the concatenated cost trace under ``.cost`` and
    the TOTAL executed iterations under ``.n_iters``; returns the
    checkpointed state as-is if the run is already complete.

    Example::

        res = run_checkpointed(nt.nmf, V, 64, total_iters=500, chunk=50,
                               path="run.npz", divergence="kl")

    ``backend`` selects the persistence layer: ``"npz"`` (one host
    file, checkpoint.save_factors), ``"orbax"`` (directory checkpoint
    with per-shard writes and sharded restore — the right choice for
    mesh runs, see checkpoint_orbax), or ``"auto"`` (default): orbax
    when the path has no ``.npz`` suffix AND the run is sharded
    (``config['mesh']``), npz otherwise.
    """
    if backend == "auto":
        backend = ("orbax" if config.get("mesh") is not None
                   and not os.fspath(path).endswith(".npz") else "npz")
    if backend == "orbax":
        from .checkpoint_orbax import load_factors_orbax, save_factors_orbax
        mesh = config.get("mesh")
        sname = getattr(solver, "__name__", None)
        def _load(p, as_inits=False):
            return load_factors_orbax(p, as_inits, mesh=mesh, solver=sname)
        _save = save_factors_orbax
        exists = os.path.isdir(os.fspath(path))
    elif backend == "npz":
        _load, _save = load_factors, save_factors
        exists = os.path.exists(os.fspath(path))
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")

    tolerance = float(config.get("tolerance", 1e-3))
    done = 0
    inits: dict = {}
    costs = []
    resume_state = None
    if resume and exists:
        raw = _load(path, as_inits=False)
        inits = {f"{k}_init": v for k, v in raw.items() if k in _FACTOR_KEYS}
        done = int(raw.get("extra__iters_done", 0))
        if "extra__cost_so_far" in raw:
            costs = [np.asarray(raw["extra__cost_so_far"])]
        rs = {k[len("extra__resume_"):]: raw[k] for k in raw
              if k.startswith("extra__resume_")}
        if rs:
            resume_state = rs
    res = None
    converged = False
    while done < total_iters and not converged:
        step = min(chunk, total_iters - done)
        cfg = dict(config)
        cfg.update(inits)
        if inits:
            # factors restored from the checkpoint supersede any seeding
            # choice; solvers reject init='nndsvd*' alongside W_init
            cfg.pop("init", None)
        if resume_state is not None:
            cfg["resume_state"] = resume_state
        res = solver(V, *args, maxiter=step, **cfg)
        done += int(res.n_iters) if res.n_iters else step
        chunk_cost = np.asarray(res.cost)
        if costs and len(chunk_cost) and len(costs[-1]):
            prev_last = costs[-1][-1]
            # Offset-trace solvers (nmfsc/cnmfsc/chcnmf) re-store the
            # boundary cost as their initial entry; those traces have
            # length n_iters+1.  Gate the duplicate-drop on that trace
            # shape AND value equality, so a genuine bit-identical
            # plateau in a length-n_iters solver is never swallowed.
            offset_trace = len(chunk_cost) == int(res.n_iters) + 1
            if offset_trace and chunk_cost[0] == prev_last:
                chunk_cost = chunk_cost[1:]
            # host-side boundary convergence check (the device loop can
            # only compare within its own chunk)
            if (len(chunk_cost) and chunk_cost[0] < prev_last
                    and prev_last - chunk_cost[0] < tolerance):
                converged = True
        costs.append(chunk_cost)
        inits = {f"{k}_init": getattr(res, k) for k in _FACTOR_KEYS
                 if getattr(res, k, None) is not None}
        resume_state = getattr(res, "resume_state", None)
        converged = converged or bool(res.converged)
        extra = {"iters_done": done, "cost_so_far": np.concatenate(costs)}
        if resume_state is not None:
            # npz needs host arrays; orbax saves device scalars as-is.
            conv = np.asarray if backend == "npz" else (lambda v: v)
            extra.update({f"resume_{k}": conv(v)
                          for k, v in resume_state.items()})
        _save(path, res, extra=extra)
    if res is None:
        # Already complete at entry: reconstruct a Result from the
        # checkpoint instead of crashing the caller.
        from ..core import Result
        raw = _load(path, as_inits=False)
        fields = tuple(k for k in _FACTOR_KEYS if k in raw) + ("cost",)
        res = Result(fields=fields,
                     **{k: raw[k] for k in _FACTOR_KEYS if k in raw})
        res.converged = True
    res.cost = np.concatenate(costs) if costs else np.asarray(res.cost)
    res.n_iters = done
    res.converged = bool(res.converged) or converged
    return res
