"""Golden-parity + property tests for nmf (SURVEY.md section 4)."""
import numpy as np
import pytest

import nmf_toolbox_tpu as nt
import oracle


def make_problem(m=40, n=30, k=5, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0


@pytest.mark.parametrize("div", ["euclidean", "kl", "is"])
def test_parity_divergences(div):
    V, W0, H0 = make_problem()
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence=div,
                 maxiter=30, tolerance=1e-12, dtype=np.float64)
    Wg, Hg, cg = oracle.nmf(V, [W0], [H0], divergence=div,
                            maxiter=30, tolerance=1e-12)
    np.testing.assert_allclose(res.cost, cg, rtol=1e-10)
    np.testing.assert_allclose(res.W, Wg[0], atol=1e-10)
    np.testing.assert_allclose(res.H, Hg[0], atol=1e-10)


def test_parity_divergence_aliases():
    V, W0, H0 = make_problem()
    a = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence="kl_divergence",
               maxiter=5, dtype=np.float64)
    b = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence="kl",
               maxiter=5, dtype=np.float64)
    np.testing.assert_array_equal(a.W, b.W)


def test_parity_ab():
    V, W0, H0 = make_problem()
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence="ab",
                 alpha=0.5, beta=0.5, maxiter=20, tolerance=1e-12,
                 dtype=np.float64)
    Wg, Hg, cg = oracle.nmf(V, [W0], [H0], divergence="ab",
                            alpha=0.5, beta=0.5, maxiter=20, tolerance=1e-12)
    np.testing.assert_allclose(res.cost, cg, rtol=1e-10)
    np.testing.assert_allclose(res.W, Wg[0], atol=1e-10)


def test_parity_ab_dual_updates():
    """alpha=0 selects the dual update equations (nmf.m:124-128,159-160).
    The reference's AB cost is Inf when alpha*beta == 0, so only factors
    are compared, over few iterations."""
    V, W0, H0 = make_problem()
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence="ab",
                 alpha=0.0, beta=2.0, maxiter=3, dtype=np.float64)
    Wg, Hg, _ = oracle.nmf(V, [W0], [H0], divergence="ab",
                           alpha=0.0, beta=2.0, maxiter=3)
    np.testing.assert_allclose(res.W, Wg[0], atol=1e-10)
    np.testing.assert_allclose(res.H, Hg[0], atol=1e-8)


def test_gram_naive_agree():
    V, W0, H0 = make_problem()
    a = nt.nmf(V, 5, W_init=W0, H_init=H0, method="gram",
               maxiter=40, tolerance=1e-12, dtype=np.float64)
    b = nt.nmf(V, 5, W_init=W0, H_init=H0, method="naive",
               maxiter=40, tolerance=1e-12, dtype=np.float64)
    np.testing.assert_allclose(a.W, b.W, atol=1e-9)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-9)


def test_multi_source_sparsity_fixed():
    V, W0, H0 = make_problem()
    rng = np.random.default_rng(1)
    W1 = rng.uniform(size=(40, 3))
    H1 = rng.uniform(size=(3, 30))
    res = nt.nmf(V, [5, 3], W_init=[W0, W1], H_init=[H0, H1],
                 W_sparsity=[0.1, 0.0], H_sparsity=0.05,
                 W_fixed=[False, True], maxiter=25, tolerance=1e-12,
                 dtype=np.float64)
    Wg, Hg, cg = oracle.nmf(V, [W0, W1], [H0, H1],
                            W_sparsity=[0.1, 0.0], H_sparsity=[0.05, 0.05],
                            W_fixed=[False, True], maxiter=25, tolerance=1e-12)
    assert isinstance(res.W, list) and len(res.W) == 2
    for s in range(2):
        np.testing.assert_allclose(res.W[s], Wg[s], atol=1e-10)
        np.testing.assert_allclose(res.H[s], Hg[s], atol=1e-9)
    np.testing.assert_allclose(res.cost, cg, rtol=1e-9)
    # the fixed source's basis must be untouched apart from the initial
    # unit-L2 normalization (nmf.m:132-134)
    np.testing.assert_allclose(
        res.W[1], W1 / np.sqrt((W1**2).sum(0)), atol=1e-12)


def test_early_stop_and_trim():
    V, W0, H0 = make_problem()
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, maxiter=200, tolerance=1e-2,
                 dtype=np.float64)
    _, _, cg = oracle.nmf(V, [W0], [H0], maxiter=200, tolerance=1e-2)
    assert len(res.cost) == len(cg) < 200
    assert res.converged
    np.testing.assert_allclose(res.cost, cg, rtol=1e-9)


@pytest.mark.parametrize("div", ["euclidean", "kl", "is"])
def test_monotone_cost(div):
    """MU cost must be non-increasing (the convergence rule presumes it)."""
    V, W0, H0 = make_problem(seed=3)
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, divergence=div,
                 maxiter=50, tolerance=0, dtype=np.float64)
    c = res.cost
    assert np.all(np.diff(c) <= 1e-9 * np.abs(c[:-1]))


def test_unit_l2_invariant():
    V, W0, H0 = make_problem()
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, maxiter=10, dtype=np.float64)
    np.testing.assert_allclose(np.sqrt((np.asarray(res.W)**2).sum(0)),
                               np.ones(5), atol=1e-12)


def test_default_init_runs_f32():
    V, _, _ = make_problem()
    res = nt.nmf(V.astype(np.float32), 5, maxiter=10, seed=42)
    assert res.W.dtype == np.float32
    assert np.all(np.isfinite(res.cost))
    assert np.all(np.asarray(res.W) >= 0)


def test_bad_inputs():
    V, W0, H0 = make_problem()
    with pytest.raises(ValueError):
        nt.nmf(V, 5, divergence="ab", alpha=0.0, beta=0.0)
    with pytest.raises(ValueError):
        nt.nmf(V, [5, 3], W_init=[W0])
    with pytest.raises(ValueError):
        nt.nmf(V, 5, W_init=W0[:, :3])
    with pytest.raises(ValueError):
        nt.nmf(V, 5, divergence="bogus")


def test_reconstruct_matches_reference_semantics():
    rng = np.random.default_rng(0)
    W = rng.uniform(size=(6, 4))
    H = rng.uniform(size=(4, 9))
    np.testing.assert_allclose(np.asarray(nt.reconstruct(W, H)), W @ H,
                               rtol=1e-12)
    W3 = rng.uniform(size=(6, 4, 3))
    np.testing.assert_allclose(np.asarray(nt.reconstruct(W3, H)),
                               oracle.reconstruct(W3, H), rtol=1e-12)
    # cell-array flattening (RFD.m:23-28)
    np.testing.assert_allclose(
        np.asarray(nt.reconstruct([W[:, :2], W[:, 2:]], [H[:2], H[2:]])),
        W @ H, rtol=1e-12)


def test_h_fixed_parity():
    V, W0, H0 = make_problem(seed=7)
    res = nt.nmf(V, 5, W_init=W0, H_init=H0, H_fixed=True, maxiter=15,
                 tolerance=1e-12, dtype=np.float64)
    Wg, Hg, cg = oracle.nmf(V, [W0], [H0], H_fixed=[True], maxiter=15,
                            tolerance=1e-12)
    np.testing.assert_allclose(res.W, Wg[0], atol=1e-10)
    np.testing.assert_array_equal(res.H, H0)  # untouched
    np.testing.assert_allclose(res.cost, cg, rtol=1e-9)


def test_data_dtype_bf16_storage():
    # data_dtype stores V in bf16 on the gram path; MU dots feed the matmul
    # the storage dtype and accumulate f32, so the trajectory must stay
    # close to the f32 run (V itself is quantized, so this is loose).
    import numpy as np
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(0)
    V = (rng.gamma(2.0, 1.0, (120, 80)) @ rng.gamma(0.5, 1.0, (80, 60))
         + 0.01).astype(np.float32)
    W0 = rng.uniform(size=(120, 8)).astype(np.float32)
    H0 = rng.uniform(size=(8, 60)).astype(np.float32)
    r32 = nt.nmf(V, 8, W_init=W0, H_init=H0, maxiter=20, tolerance=1e-30)
    rbf = nt.nmf(V, 8, W_init=W0, H_init=H0, maxiter=20, tolerance=1e-30,
                 data_dtype="bfloat16")
    assert rbf.W.dtype == np.float32  # factors stay in the compute dtype
    rel = abs(rbf.cost[-1] - r32.cost[-1]) / r32.cost[-1]
    assert rel < 0.05
    import pytest
    with pytest.raises(ValueError, match="data_dtype"):
        nt.nmf(V, 8, divergence="kl", data_dtype="bfloat16")
