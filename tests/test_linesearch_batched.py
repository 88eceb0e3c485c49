"""Parallel (batched) backtracking must reproduce sequential halving
exactly: the accepted candidate is the first acceptable step in halving
order, and underflows that occur before a later acceptable candidate
still win."""
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


@pytest.mark.parametrize("width", [1, 4, 8])
def test_nmfsc_batched_matches_sequential(width):
    V, W0, H0 = _problem()
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=15, tolerance=1e-30,
              dtype=np.float64)
    a = nt.nmfsc(V, 4, W_init=W0, H_init=H0, **kw)
    b = nt.nmfsc(V, 4, W_init=W0, H_init=H0, linesearch_width=width, **kw)
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(b.H, a.H)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))
    assert b.resume_state == a.resume_state


def test_cnmfsc_batched_matches_sequential():
    V, _, H0 = _problem(seed=2)
    rng = np.random.default_rng(3)
    W0 = rng.uniform(size=(30, 4, 3))
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, maxiter=10, tolerance=1e-30,
              dtype=np.float64)
    a = nt.cnmfsc(V, 4, 3, W_init=W0, H_init=H0, **kw)
    b = nt.cnmfsc(V, 4, 3, W_init=W0, H_init=H0, linesearch_width=6, **kw)
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(b.H, a.H)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_batched_underflow_termination_matches():
    rng = np.random.default_rng(5)
    V = np.outer(rng.uniform(0.5, 1, 12), rng.uniform(0.5, 1, 15))
    W0 = rng.uniform(size=(12, 2))
    H0 = rng.uniform(size=(2, 15))
    kw = dict(W_sparsity=0.9, H_sparsity=0.9, tolerance=0.0,
              dtype=np.float64, maxiter=400)
    a = nt.nmfsc(V, 2, W_init=W0, H_init=H0, **kw)
    b = nt.nmfsc(V, 2, W_init=W0, H_init=H0, linesearch_width=8, **kw)
    assert a.converged and b.converged
    assert b.n_iters == a.n_iters
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(np.asarray(b.cost), np.asarray(a.cost))


def test_resolve_width_auto():
    """None/'auto' resolves by platform (8 on GPU, sequential elsewhere);
    integers pass through; a mesh's devices decide over the default
    backend."""
    import jax
    from nmf_toolbox_tpu.ops.linesearch import resolve_width
    from nmf_toolbox_tpu.parallel import make_mesh

    assert resolve_width(0) == 0
    assert resolve_width(6) == 6
    assert resolve_width("3") == 3
    # this suite pins JAX_PLATFORMS=cpu (conftest), so auto = sequential
    assert resolve_width(None) == 0
    assert resolve_width("auto") == 0
    assert resolve_width(None, mesh=make_mesh(8)) == 0
    # GPU backend resolves auto to the batched width
    orig = jax.default_backend
    jax.default_backend = lambda: "gpu"
    try:
        assert resolve_width(None) == 8
        assert resolve_width("auto") == 8
        assert resolve_width(0) == 0          # explicit always wins
        # a CPU mesh overrides a GPU default backend
        assert resolve_width(None, mesh=make_mesh(8)) == 0
    finally:
        jax.default_backend = orig


def test_batched_mesh_composes():
    from nmf_toolbox_tpu.parallel import make_mesh
    V, W0, H0 = _problem(m=17, n=43, k=3, seed=7)
    kw = dict(H_sparsity=0.5, maxiter=6, tolerance=1e-30, dtype=np.float64)
    a = nt.nmfsc(V, 3, W_init=W0[:, :3], H_init=H0[:3], **kw)
    b = nt.nmfsc(V, 3, W_init=W0[:, :3], H_init=H0[:3], mesh=make_mesh(8),
                 linesearch_width=4, **kw)
    np.testing.assert_allclose(b.W, a.W, atol=1e-9)
    np.testing.assert_allclose(np.asarray(b.cost), np.asarray(a.cost),
                               rtol=1e-9)
