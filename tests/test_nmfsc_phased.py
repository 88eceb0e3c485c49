"""Phase-split nmfsc dispatch (models/nmfsc_phased.py) must reproduce
the fused single-program solver BIT-identically: same math, same order,
different program partitioning."""
import numpy as np
import pytest

import nmf_toolbox_tpu as nt


def _problem(m=30, n=40, k=4, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    H0 = H0 / np.sqrt((H0**2).sum(1, keepdims=True))
    return V, W0, H0


@pytest.mark.parametrize("kw", [
    dict(W_sparsity=0.5, H_sparsity=0.6),
    dict(W_sparsity=0.5),          # sparse W + MU H (renorm transfer)
    dict(H_sparsity=0.6),          # MU W + sparse H
    dict(W_sparsity=0.8, H_sparsity=0.3, W_fixed=True),
])
def test_phased_bit_identical(kw):
    V, W0, H0 = _problem()
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=15, tolerance=1e-30,
                 dtype=np.float64, **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=15, tolerance=1e-30,
                 dtype=np.float64, dispatch="phased", **kw)
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(b.H, a.H)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))
    assert b.n_iters == a.n_iters
    assert b.resume_state == a.resume_state


def test_phased_tolerance_stop_matches():
    V, W0, H0 = _problem(seed=3)
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, tolerance=1e-4,
              dtype=np.float64)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=100, **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=100,
                 dispatch="phased", **kw)
    assert b.n_iters == a.n_iters and b.converged == a.converged
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_phased_underflow_termination_matches():
    """Force a line-search underflow (rank-1 exact fit goes flat fast at
    high sparsity) and check the mid-iteration return convention."""
    rng = np.random.default_rng(5)
    V = np.outer(rng.uniform(0.5, 1, 12), rng.uniform(0.5, 1, 15))
    W0 = rng.uniform(size=(12, 2))
    H0 = rng.uniform(size=(2, 15))
    kw = dict(W_sparsity=0.9, H_sparsity=0.9, tolerance=0.0,
              dtype=np.float64, maxiter=400)
    a = nt.nmfsc(V, 2, W_init=W0, H_init=H0, **kw)
    b = nt.nmfsc(V, 2, W_init=W0, H_init=H0, dispatch="phased", **kw)
    assert a.converged and b.converged
    assert b.n_iters == a.n_iters
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(b.H, a.H)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_phased_resume_round_trip():
    V, W0, H0 = _problem(seed=7)
    kw = dict(W_sparsity=0.5, H_sparsity=0.5, tolerance=1e-30,
              dtype=np.float64)
    ref = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=12, **kw)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=5,
                 dispatch="phased", **kw)
    b = nt.nmfsc(V, 4, W_init=a.W, H_init=a.H, maxiter=7,
                 resume_state=a.resume_state, dispatch="phased", **kw)
    np.testing.assert_array_equal(b.W, ref.W)
    np.testing.assert_array_equal(b.H, ref.H)


def test_phased_rejects_mesh():
    V, W0, H0 = _problem()
    from nmf_toolbox_tpu.parallel import make_mesh
    with pytest.raises(ValueError, match="single-device"):
        nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=2, dispatch="phased",
                 H_sparsity=0.5, mesh=make_mesh(1))


def test_phased_slow_path_variants():
    """trials=2 forces frequent in-program non-resolution (host fallback
    redo); fuse_iteration=False forces the per-phase path everywhere.
    All variants must stay bit-identical to the fused solver."""
    V, W0, H0 = _problem(seed=11)
    kw = dict(W_sparsity=0.6, H_sparsity=0.6, maxiter=12, tolerance=1e-30,
              dtype=np.float64)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, **kw)
    for extra in (dict(trials=2), dict(fuse_iteration=False),
                  dict(trials=3, fuse_iteration=False)):
        b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch="phased",
                     **extra, **kw)
        np.testing.assert_array_equal(b.W, a.W)
        np.testing.assert_array_equal(b.H, a.H)
        np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_phased_batched_trials_close():
    """batched_trials=True deviates only at ulp level (different XLA
    tiling of the batched candidate evaluation)."""
    V, W0, H0 = _problem(seed=13)
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=12, tolerance=1e-30,
              dtype=np.float64)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch="phased", **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch="phased",
                 batched_trials=True, **kw)
    np.testing.assert_allclose(b.W, a.W, atol=1e-10)
    np.testing.assert_allclose(np.asarray(b.cost), np.asarray(a.cost),
                               rtol=1e-10)


def test_bad_dispatch_rejected():
    V, W0, H0 = _problem()
    with pytest.raises(ValueError, match="unknown dispatch"):
        nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=2, dispatch="Phased")
    # explicit default spelling is accepted
    r = nt.nmfsc(V, 4, W_init=W0, H_init=H0, H_sparsity=0.5, maxiter=2,
                 dispatch="fused", dtype=np.float64)
    assert r.n_iters == 2


def test_phased_linesearch_width_composes():
    """linesearch_width maps onto the phased batched trial rounds
    instead of being silently dropped (review finding)."""
    V, W0, H0 = _problem(seed=17)
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=10, tolerance=1e-30,
              dtype=np.float64, dispatch="phased")
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, batched_trials=True,
                 trials=8, **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, linesearch_width=8, **kw)
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_empty_resume_state_is_fresh_run():
    """resume_state={} must behave exactly like a fresh run (initial
    projections + unit stepsizes), not a half-resume (review finding)."""
    V, W0, H0 = _problem(seed=19)
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=6, tolerance=1e-30,
              dtype=np.float64)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, resume_state={}, **kw)
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))
    rng = np.random.default_rng(3)
    W0c = rng.uniform(size=(30, 4, 3))
    c1 = nt.cnmfsc(V, 4, 3, W_init=W0c, H_init=H0, **kw)
    c2 = nt.cnmfsc(V, 4, 3, W_init=W0c, H_init=H0, resume_state={}, **kw)
    np.testing.assert_array_equal(c2.W, c1.W)


def test_phased_f32_trace_dtype():
    V, W0, H0 = _problem()
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=4, H_sparsity=0.5,
                 dispatch="phased", dtype=np.float32)
    assert np.asarray(b.cost).dtype == np.float32
    assert len(b.cost) == 5  # initial cost + 4 iterations
