"""Device-mesh sharding for the solver family (SURVEY.md section 2.5).

The reference is single-threaded MATLAB; all parallelism here is
greenfield accelerator design.  The strategy:

* V (m, n) shards over samples (columns) and optionally features (rows)
  on a 1-D or 2-D mesh; H (k, n) shards with V's columns; W (m, k)
  shards with V's rows (replicated on a 1-D sample mesh).
* Every cross-shard quantity in the MU updates is a k-by-k / m-by-k
  reduction (V H', W'V, H H', W'W) — XLA inserts the psum over ICI
  automatically when the jitted step consumes the sharded operands.
* Convolutive shifts touch at most context_len-1 neighbor columns; under
  pjit the static pad/slice lowers to a collective-permute halo exchange.

Solvers take a ``mesh=`` config entry; inputs are placed with these
shardings before entering the jitted while_loop, and XLA propagates the
layout through the loop carry.  No solver code changes — placement is
purely at the boundary, which is exactly how pjit is meant to be used.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SAMPLE_AXIS = "n"   # data-parallel over samples (columns of V)
FEATURE_AXIS = "m"  # feature-parallel over rows of V (tensor-parallel analog)


def make_mesh(n_devices: int | None = None, *, shape=None, devices=None) -> Mesh:
    """Build a mesh over the sample axis (1-D) or (features, samples) (2-D).

    ``shape=(r, c)`` gives a 2-D mesh with axes (FEATURE_AXIS, SAMPLE_AXIS).
    Default: all devices on the sample axis.
    """
    devs = list(devices if devices is not None else jax.devices())
    if shape is not None:
        r, c = shape
        arr = np.asarray(devs[: r * c]).reshape(r, c)
        return Mesh(arr, (FEATURE_AXIS, SAMPLE_AXIS))
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]), (SAMPLE_AXIS,))


def _axes(mesh: Mesh):
    names = mesh.axis_names
    m_ax = FEATURE_AXIS if FEATURE_AXIS in names else None
    n_ax = SAMPLE_AXIS if SAMPLE_AXIS in names else None
    return m_ax, n_ax


def col_sharding(mesh: Mesh) -> NamedSharding:
    """(x, n)-shaped arrays sharded over samples."""
    m_ax, n_ax = _axes(mesh)
    return NamedSharding(mesh, P(None, n_ax))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """(m, x)-shaped arrays sharded over features."""
    m_ax, n_ax = _axes(mesh)
    return NamedSharding(mesh, P(m_ax, None))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """(m, n)-shaped arrays sharded over both axes (2-D mesh)."""
    m_ax, n_ax = _axes(mesh)
    return NamedSharding(mesh, P(m_ax, n_ax))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard(mesh: Mesh, x, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


# Placement tables per solver: name -> PartitionSpec builder.  Axes that a
# mesh doesn't carry resolve to None (replicated along that dim).
def placements_for(solver: str, mesh: Mesh) -> dict:
    m_ax, n_ax = _axes(mesh)
    V = P(m_ax, n_ax)        # data
    Wrow = P(m_ax, None)     # basis: rows with features
    Hcol = P(None, n_ax)     # encoding: columns with samples
    table = {
        "nmf": {"V": V, "W": Wrow, "H": Hcol},
        "lnmf": {"V": V, "W": Wrow, "H": Hcol},
        "nmfsc": {"V": V, "W": Wrow, "H": Hcol},
        "seminmf": {"V": V, "W": Wrow, "H": Hcol},
        "constrainednmf": {"V": V, "W": Wrow, "Z": P(None, None)},
        "cnmf": {"V": V, "W": P(m_ax, None, None), "H": Hcol},
        "cnmfsc": {"V": V, "W": P(m_ax, None, None),
                   "W2": P(m_ax, None, None), "H": Hcol},
        "cmfwisa": {"V": V, "W": Wrow, "H": Hcol, "P": P(None, m_ax, n_ax)},
        # symmetric NMF: A's rows and H's rows shard together over the
        # feature axis, A's columns over the sample axis; the (k, k)
        # Gram reductions psum.
        "symnmf": {"A": V, "H": Wrow},
        # 2-D deconvolution: samples shard (time halos as in cnmf); the
        # feature axis stays replicated so the pitch shifts are
        # device-local (models/nmf2d.py docstring).
        "nmf2d": {"V": P(None, n_ax), "W": P(None, None, None),
                  "H": P(None, n_ax, None)},
        # Gram family: the n-by-n Gram shards over samples on one side.
        "convexnmf": {"V": V, "G": P(n_ax, None), "H": Hcol},
        "chnmf": {"V": V, "S": Wrow, "G": P(None, None), "H": Hcol},
        # chcnmf's placed "V" is the p-by-n Gram S'V: the hull size p is
        # data-dependent and small, so its axis is REPLICATED (sharding it
        # over the feature axis would demand p % mesh == 0 for no gain).
        "chcnmf": {"V": P(None, n_ax), "S": Wrow,
                   "G": P(None, None, None), "H": Hcol},
        # batched serving: shard the BATCH axis (data-parallel problems);
        # the sample axis of the mesh carries the batch dimension here.
        "nmf_batched": {"V": P(n_ax, None, None), "W": P(n_ax, None, None),
                        "H": P(n_ax, None, None)},
        # fixed-dictionary encoding: problems shard over the batch axis,
        # the shared dictionary (m-by-k, small) is replicated.
        "nmf_encode": {"V": P(n_ax, None, None), "W": P(None, None),
                       "H": P(n_ax, None, None)},
        "cnmf_encode": {"V": P(n_ax, None, None), "W": P(None, None, None),
                        "H": P(n_ax, None, None)},
        # complex encode: V/P ship as real planes (B, m, n)/(B, S, m, n);
        # problems shard over the batch axis like the other encodes.
        "cmfwisa_encode": {"V": P(n_ax, None, None), "W": P(None, None),
                           "H": P(n_ax, None, None),
                           "P": P(n_ax, None, None, None)},
        "nmf2d_encode": {"V": P(n_ax, None, None),
                         "W": P(None, None, None),
                         "H": P(n_ax, None, None, None)},
        # multi-restart (rank selection): the SHARED V shards over
        # features only (every restart reads all of it), restarts
        # shard over the sample axis — pure data parallelism, the only
        # collectives are the psums of W's row-reductions along m_ax.
        "nmf_multiseed": {"V": P(m_ax, None), "W": P(n_ax, m_ax, None),
                          "H": P(n_ax, None, None)},
    }
    return table[solver]


def apply_placements(mesh: Mesh | None, solver: str, **arrays):
    """device_put each named array with its solver placement; identity when
    mesh is None.  Returns the arrays in the given order."""
    if mesh is None:
        out = tuple(arrays.values())
        return out if len(out) > 1 else out[0]
    specs = placements_for(solver, mesh)
    out = tuple(
        jax.device_put(a, NamedSharding(mesh, specs[name]))
        for name, a in arrays.items()
    )
    return out if len(out) > 1 else out[0]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Initialize multi-host JAX (jax.distributed.initialize pass-through).

    Call once per process before building a mesh in a multi-host run;
    ``make_mesh()`` then sees every host's devices via jax.devices() and
    the solver placements work unchanged — XLA routes the Gram psums
    over the fastest link within a host and the network across hosts
    (SURVEY.md section 2.5).  No-op arguments use JAX's environment
    auto-detection where the cluster provides it.
    """
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)
