"""Batched (vmapped) NMF tests."""
import numpy as np

from nmf_toolbox_tpu import nmf_batched

import nmf_toolbox_tpu as nt


def test_batched_matches_per_problem():
    rng = np.random.default_rng(0)
    B, m, n, k = 4, 20, 28, 3
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W0 = rng.uniform(size=(B, m, k))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.nmf_batched(Vs, k, W_init=W0, H_init=H0, maxiter=15,
                         dtype=np.float64)
    assert res.W.shape == (B, m, k) and res.cost.shape == (B, 15)
    for b in range(B):
        ref = nt.nmf(Vs[b], k, W_init=W0[b], H_init=H0[b], maxiter=15,
                     tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.W[b], ref.W, atol=1e-9)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_batched_default_inits_and_validation():
    import pytest
    rng = np.random.default_rng(1)
    Vs = rng.uniform(0.1, 1, (3, 12, 16)).astype(np.float32)
    res = nt.nmf_batched(Vs, 2, maxiter=10, seed=4)
    assert np.all(np.isfinite(res.cost))
    assert np.all(np.diff(res.cost, axis=1) <= 1e-3 * np.abs(res.cost[:, :-1]))
    with pytest.raises(ValueError, match="B, m, n"):
        nt.nmf_batched(Vs[0], 2)


def test_batched_sharded_matches_single_device():
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(2)
    B, m, n, k = 16, 12, 18, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W0 = rng.uniform(size=(B, m, k))
    H0 = rng.uniform(size=(B, k, n))
    a = nt.nmf_batched(Vs, k, W_init=W0, H_init=H0, maxiter=10,
                       dtype=np.float64)
    b = nt.nmf_batched(Vs, k, W_init=W0, H_init=H0, maxiter=10,
                       dtype=np.float64, mesh=make_mesh(8))
    np.testing.assert_allclose(a.W, b.W, atol=1e-10)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_batched_kl_matches_per_problem():
    """divergence='kl' per-problem trajectories pin against the single
    solver's naive KL path."""
    rng = np.random.default_rng(5)
    B, m, n, k, iters = 3, 11, 14, 3, 15
    Vs = rng.random((B, m, n)) + 0.05
    W0 = rng.random((B, m, k))
    H0 = rng.random((B, k, n))
    res = nmf_batched(Vs, k, divergence="kl", W_init=W0, H_init=H0,
                      maxiter=iters, dtype="float64")
    for b in range(B):
        ref = nt.nmf(Vs[b], k, divergence="kl", method="naive",
                     W_init=W0[b], H_init=H0[b], maxiter=iters,
                     tolerance=0.0, dtype="float64")
        np.testing.assert_allclose(res.W[b], ref.W, rtol=1e-10)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-10)


def test_batched_rejects_other_divergences():
    import pytest
    with pytest.raises(ValueError, match="euclidean.*or.*kl"):
        nmf_batched(np.ones((2, 4, 5)), 2, divergence="ab", maxiter=2)


def test_batched_inner_iters_matches_gram():
    """Accelerated MU in the batched engines pins against
    nmf(method='gram', inner_iters=)."""
    import pytest
    from nmf_toolbox_tpu import nmf_multiseed
    rng = np.random.default_rng(8)
    V = rng.random((10, 13))
    S, k, iters, inner = 2, 3, 10, 3
    W0 = rng.random((S, 10, k))
    H0 = rng.random((S, k, 13))
    res = nmf_multiseed(V, k, S, W_init=W0, H_init=H0, maxiter=iters,
                        inner_iters=inner, dtype="float64")
    for s in range(S):
        ref = nt.nmf(V, k, W_init=W0[s], H_init=H0[s], maxiter=iters,
                     method="gram", inner_iters=inner, tolerance=0.0,
                     dtype="float64")
        np.testing.assert_allclose(res.W[s], ref.W, rtol=1e-10)
        np.testing.assert_allclose(res.cost[s], ref.cost, rtol=1e-10)
    Vs = rng.random((2, 10, 13))
    resb = nmf_batched(Vs, k, W_init=W0, H_init=H0, maxiter=iters,
                       inner_iters=inner, dtype="float64")
    for b in range(2):
        ref = nt.nmf(Vs[b], k, W_init=W0[b], H_init=H0[b], maxiter=iters,
                     method="gram", inner_iters=inner, tolerance=0.0,
                     dtype="float64")
        np.testing.assert_allclose(resb.W[b], ref.W, rtol=1e-10)
    with pytest.raises(ValueError, match="euclidean"):
        nmf_batched(Vs, k, divergence="kl", inner_iters=2, maxiter=2)


def test_batched_data_dtype_bf16():
    """bf16 V storage (serving HBM economy): factors stay f32 and the
    trajectory tracks the f32 run to bf16-level tolerance."""
    import pytest
    from nmf_toolbox_tpu import nmf_multiseed
    rng = np.random.default_rng(9)
    Vs = rng.random((2, 24, 32)).astype(np.float32)
    W0 = rng.random((2, 24, 4)).astype(np.float32)
    H0 = rng.random((2, 4, 32)).astype(np.float32)
    a = nmf_batched(Vs, 4, W_init=W0, H_init=H0, maxiter=15)
    b = nmf_batched(Vs, 4, W_init=W0, H_init=H0, maxiter=15,
                    data_dtype="bfloat16")
    assert b.W.dtype == np.float32
    np.testing.assert_allclose(a.cost[:, -1], b.cost[:, -1], rtol=0.05)
    m = nmf_multiseed(Vs[0], 4, 2, W_init=W0, H_init=H0[:, :, :32],
                      maxiter=15, data_dtype="bfloat16")
    assert m.W.dtype == np.float32 and np.all(np.isfinite(m.cost))
    with pytest.raises(ValueError, match="data_dtype"):
        nmf_batched(Vs, 4, divergence="kl", data_dtype="bfloat16", maxiter=2)


def test_device_output():
    """device_output=True keeps the factors as jax arrays (serving:
    no forced host round trip); values match the fetched run."""
    import jax
    rng = np.random.default_rng(10)
    Vs = rng.random((2, 12, 15)).astype(np.float32)
    W0 = rng.random((2, 12, 3)).astype(np.float32)
    H0 = rng.random((2, 3, 15)).astype(np.float32)
    a = nmf_batched(Vs, 3, W_init=W0, H_init=H0, maxiter=5)
    b = nmf_batched(Vs, 3, W_init=W0, H_init=H0, maxiter=5,
                    device_output=True)
    assert isinstance(b.W, jax.Array) and isinstance(b.H, jax.Array)
    np.testing.assert_array_equal(a.W, np.asarray(b.W))
    from nmf_toolbox_tpu import nmf_multiseed
    m = nmf_multiseed(Vs[0], 3, 2, maxiter=5, device_output=True)
    assert isinstance(m.W, jax.Array)
    assert m.final_cost == float(np.min(m.cost[:, -1]))


def test_encode_matches_fixed_w_single():
    """nmf_encode per-problem trajectories pin against
    nmf(V, k, W_init=W, W_fixed=True) — euclid Gram form."""
    rng = np.random.default_rng(7)
    B, m, n, k, iters = 4, 18, 22, 3, 15
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.nmf_encode(Vs, W, H_init=H0, maxiter=iters, dtype=np.float64)
    assert res.H.shape == (B, k, n) and res.cost.shape == (B, iters)
    for b in range(B):
        ref = nt.nmf(Vs[b], k, W_init=W, W_fixed=True, H_init=H0[b],
                     maxiter=iters, tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_encode_kl_matches_fixed_w_single():
    rng = np.random.default_rng(8)
    B, m, n, k, iters = 3, 12, 16, 2, 12
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.nmf_encode(Vs, W, H_init=H0, divergence="kl", maxiter=iters,
                        dtype=np.float64)
    for b in range(B):
        ref = nt.nmf(Vs[b], k, W_init=W, W_fixed=True, H_init=H0[b],
                     divergence="kl", maxiter=iters, tolerance=1e-30,
                     dtype=np.float64)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_encode_sparsity_matches_fixed_w_single():
    """H_sparsity (sparse coding) pins against the single solver's
    penalty path, including the cost's L1 term (nmf.m:216-218)."""
    rng = np.random.default_rng(9)
    B, m, n, k, iters = 2, 14, 18, 3, 12
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.nmf_encode(Vs, W, H_init=H0, H_sparsity=0.3, maxiter=iters,
                        dtype=np.float64)
    for b in range(B):
        ref = nt.nmf(Vs[b], k, W_init=W, W_fixed=True, H_init=H0[b],
                     H_sparsity=0.3, maxiter=iters, tolerance=1e-30,
                     dtype=np.float64)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_encode_sharded_matches_single_device():
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(10)
    B, m, n, k = 16, 12, 18, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    a = nt.nmf_encode(Vs, W, H_init=H0, maxiter=10, dtype=np.float64)
    b = nt.nmf_encode(Vs, W, H_init=H0, maxiter=10, dtype=np.float64,
                      mesh=make_mesh(8))
    np.testing.assert_allclose(a.H, b.H, atol=1e-10)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_encode_validation_and_device_output():
    import jax
    import pytest
    rng = np.random.default_rng(11)
    Vs = rng.uniform(0.1, 1, (2, 10, 12)).astype(np.float32)
    W = rng.uniform(size=(10, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="B, m, n"):
        nt.nmf_encode(Vs[0], W)
    with pytest.raises(ValueError, match=r"\(m, k\)"):
        nt.nmf_encode(Vs, W.T)
    with pytest.raises(ValueError, match="W_fixed"):
        nt.nmf_encode(Vs, W, W_fixed=True)
    res = nt.nmf_encode(Vs, W, maxiter=8, seed=3, device_output=True)
    assert isinstance(res.H, jax.Array)
    assert np.all(np.isfinite(res.cost))
    # MU with a fixed basis is still monotone non-increasing.
    assert np.all(np.diff(res.cost, axis=1) <= 1e-4 * np.abs(res.cost[:, :-1]))


def test_conv_encode_matches_fixed_w_single():
    """cnmf_encode per-problem trajectories pin against
    cnmf(V, k, T, W_init=W, W_fixed=True) — euclid Gram path, including
    the entry cross-frame norm transfer into H (cnmf.m:157-166)."""
    rng = np.random.default_rng(14)
    B, m, n, k, T, iters = 3, 14, 20, 3, 3, 12
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))  # deliberately unnormalized
    H0 = rng.uniform(size=(B, k, n))
    res = nt.cnmf_encode(Vs, W, H_init=H0, maxiter=iters, dtype=np.float64)
    assert res.W.shape == (m, k, T) and res.cost.shape == (B, iters)
    for b in range(B):
        ref = nt.cnmf(Vs[b], k, T, W_init=W, W_fixed=True, H_init=H0[b],
                      maxiter=iters, tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_conv_encode_kl_matches_fixed_w_single():
    """KL path pins against cnmf's kl_fast branch including the no-shift
    ones-field quirk (cnmf.m:220-224)."""
    rng = np.random.default_rng(15)
    B, m, n, k, T, iters = 2, 11, 16, 2, 3, 10
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.cnmf_encode(Vs, W, H_init=H0, divergence="kl", maxiter=iters,
                         H_sparsity=0.2, dtype=np.float64)
    for b in range(B):
        ref = nt.cnmf(Vs[b], k, T, W_init=W, W_fixed=True, H_init=H0[b],
                      divergence="kl", H_sparsity=0.2, maxiter=iters,
                      tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_conv_encode_sharded_and_validation():
    import jax
    import pytest
    rng = np.random.default_rng(16)
    B, m, n, k, T = 8, 10, 14, 2, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(B, k, n))
    with pytest.raises(ValueError, match="B, m, n"):
        nt.cnmf_encode(Vs[0], W)
    with pytest.raises(ValueError, match=r"\(m, k, T\)"):
        nt.cnmf_encode(Vs, W[:, :, 0])
    with pytest.raises(ValueError, match="W_fixed"):
        nt.cnmf_encode(Vs, W, W_fixed=True)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    a = nt.cnmf_encode(Vs, W, H_init=H0, maxiter=8, dtype=np.float64)
    b = nt.cnmf_encode(Vs, W, H_init=H0, maxiter=8, dtype=np.float64,
                       mesh=make_mesh(8))
    np.testing.assert_allclose(a.H, b.H, atol=1e-10)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_encode_multisource_matches_single():
    """A LIST of dictionaries (cell-array semantics) pins against the
    multi-source single solver with every source fixed, and unwraps
    W/H per source — the shape separate() consumes."""
    rng = np.random.default_rng(17)
    B, m, n, kA, kB, iters = 3, 16, 20, 3, 2, 10
    Vs = rng.uniform(0.1, 1, (B, m, n))
    WA = rng.uniform(size=(m, kA))
    WB = rng.uniform(size=(m, kB))
    H0 = rng.uniform(size=(B, kA + kB, n))
    res = nt.nmf_encode(Vs, [WA, WB], H_init=H0, H_sparsity=[0.0, 0.2],
                        maxiter=iters, dtype=np.float64)
    assert isinstance(res.W, list) and isinstance(res.H, list)
    assert res.W[0].shape == (m, kA) and res.H[1].shape == (B, kB, n)
    for b in range(B):
        ref = nt.nmf(Vs[b], [kA, kB], W_init=[WA, WB], W_fixed=True,
                     H_init=[H0[b, :kA], H0[b, kA:]], H_sparsity=[0.0, 0.2],
                     maxiter=iters, tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.H[0][b], ref.H[0], atol=1e-9)
        np.testing.assert_allclose(res.H[1][b], ref.H[1], atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)
    # composes with separate(): per-source factor lists, estimates sum to V
    est = np.asarray(nt.separate(Vs[0], res.W, [h[0] for h in res.H]))
    np.testing.assert_allclose(est.sum(axis=0), Vs[0], rtol=1e-6)


def test_conv_encode_multisource_matches_single():
    rng = np.random.default_rng(18)
    B, m, n, kA, kB, T, iters = 2, 12, 18, 2, 2, 3, 8
    Vs = rng.uniform(0.1, 1, (B, m, n))
    WA = rng.uniform(0.1, 1, (m, kA, T))
    WB = rng.uniform(0.1, 1, (m, kB, T))
    H0 = rng.uniform(size=(B, kA + kB, n))
    res = nt.cnmf_encode(Vs, [WA, WB], H_init=H0, divergence="kl",
                         maxiter=iters, dtype=np.float64)
    assert isinstance(res.W, list) and res.W[1].shape == (m, kB, T)
    for b in range(B):
        ref = nt.cnmf(Vs[b], [kA, kB], T, W_init=[WA, WB], W_fixed=True,
                      H_init=[H0[b, :kA], H0[b, kA:]], divergence="kl",
                      maxiter=iters, tolerance=1e-30, dtype=np.float64)
        np.testing.assert_allclose(res.H[0][b], ref.H[0], atol=1e-9)
        np.testing.assert_allclose(res.H[1][b], ref.H[1], atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)
    import pytest
    with pytest.raises(ValueError, match="context length"):
        nt.cnmf_encode(Vs, [WA, WB[:, :, :2]])


def test_encode_is_and_ab_match_fixed_w_single():
    """IS and AB (incl. the alpha=0 dual) encode trajectories pin against
    the single solver's naive W_fixed path — the full nmf() divergence
    family is available in serving (nmf.m:147-199)."""
    rng = np.random.default_rng(19)
    B, m, n, k, iters = 2, 12, 15, 3, 10
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    for div_kw in ({"divergence": "is"},
                   {"divergence": "ab", "alpha": 0.5, "beta": 1.5},
                   {"divergence": "ab", "alpha": 0.0, "beta": 2.0}):
        res = nt.nmf_encode(Vs, W, H_init=H0, maxiter=iters,
                            dtype=np.float64, **div_kw)
        for b in range(B):
            ref = nt.nmf(Vs[b], k, W_init=W, W_fixed=True, H_init=H0[b],
                         maxiter=iters, tolerance=1e-30, dtype=np.float64,
                         **div_kw)
            np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9,
                                       err_msg=str(div_kw))
            np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9,
                                       err_msg=str(div_kw))


def test_conv_encode_is_matches_fixed_w_single():
    """cnmf maps IS onto (alpha, beta) = (1, -1) (cnmf.m:137-147); the
    convolutive encode engine pins against that path."""
    rng = np.random.default_rng(20)
    B, m, n, k, T, iters = 2, 10, 14, 2, 3, 8
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(B, k, n))
    res = nt.cnmf_encode(Vs, W, H_init=H0, divergence="is", maxiter=iters,
                         dtype=np.float64)
    for b in range(B):
        ref = nt.cnmf(Vs[b], k, T, W_init=W, W_fixed=True, H_init=H0[b],
                      divergence="is", maxiter=iters, tolerance=1e-30,
                      dtype=np.float64)
        np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_encode_weighted_matches_fixed_w_single():
    """weights= (missing-data masks — the matrix-completion serving
    scorer, DESIGN.md section 13) pins against nmf(..., W_fixed=True,
    weights=M): shared (m, n) and per-problem (B, m, n) forms."""
    import pytest
    rng = np.random.default_rng(21)
    B, m, n, k, iters = 2, 14, 18, 3, 10
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    M_shared = (rng.uniform(size=(m, n)) < 0.8).astype(float)
    M_batched = (rng.uniform(size=(B, m, n)) < 0.8).astype(float)
    for div in ("euclidean", "kl"):
        for Mw, pick in ((M_shared, lambda b: M_shared),
                         (M_batched, lambda b: M_batched[b])):
            res = nt.nmf_encode(Vs, W, H_init=H0, weights=Mw,
                                divergence=div, maxiter=iters,
                                dtype=np.float64)
            for b in range(B):
                ref = nt.nmf(Vs[b], k, W_init=W, W_fixed=True,
                             H_init=H0[b], weights=pick(b), divergence=div,
                             maxiter=iters, tolerance=1e-30,
                             dtype=np.float64)
                np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9,
                                           err_msg=div)
                np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9,
                                           err_msg=div)
    with pytest.raises(ValueError, match="nonnegative"):
        nt.nmf_encode(Vs, W, weights=-M_shared, maxiter=2)
    with pytest.raises(ValueError, match="weights must be"):
        nt.nmf_encode(Vs, W, weights=np.ones((3, 3)), maxiter=2)
    with pytest.raises(ValueError, match="data_dtype"):
        nt.nmf_encode(Vs, W, weights=M_shared, data_dtype="bfloat16",
                      maxiter=2)


def test_conv_encode_weighted_matches_fixed_w_single():
    """Weighted convolutive encode uses the paper-correct SHIFTED
    positive field (the KL no-shift quirk is ones-field-only), matching
    cnmf(..., W_fixed=True, weights=M)."""
    rng = np.random.default_rng(22)
    B, m, n, k, T, iters = 2, 11, 15, 2, 3, 8
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(B, k, n))
    M = (rng.uniform(size=(m, n)) < 0.85).astype(float)
    for div in ("euclidean", "kl"):
        res = nt.cnmf_encode(Vs, W, H_init=H0, weights=M, divergence=div,
                             maxiter=iters, dtype=np.float64)
        for b in range(B):
            ref = nt.cnmf(Vs[b], k, T, W_init=W, W_fixed=True, H_init=H0[b],
                          weights=M, divergence=div, maxiter=iters,
                          tolerance=1e-30, dtype=np.float64)
            np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9,
                                       err_msg=div)
            np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9,
                                       err_msg=div)


def test_encode_rejects_inapplicable_config():
    """Silently-ignored config is a bug class (review finding): the
    encode engines error on options that cannot apply."""
    import pytest
    rng = np.random.default_rng(23)
    Vs = rng.uniform(0.1, 1, (2, 8, 10)).astype(np.float32)
    W = rng.uniform(size=(8, 2)).astype(np.float32)
    Wc = rng.uniform(size=(8, 2, 2)).astype(np.float32)
    for bad in ({"H_fixed": True}, {"inner_iters": 3}, {"W_sparsity": 0.1}):
        with pytest.raises(ValueError, match="does not apply"):
            nt.nmf_encode(Vs, W, maxiter=2, **bad)
        with pytest.raises(ValueError, match="does not apply"):
            nt.cnmf_encode(Vs, Wc, maxiter=2, **bad)
    with pytest.raises(ValueError, match="data_dtype"):
        nt.cnmf_encode(Vs, Wc, data_dtype="bfloat16", maxiter=2)


def test_encode_mesh_divisibility_error():
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(24)
    Vs = rng.uniform(0.1, 1, (3, 8, 10)).astype(np.float32)
    W = rng.uniform(size=(8, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        nt.nmf_encode(Vs, W, maxiter=2, mesh=make_mesh(8))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        nt.cnmf_encode(Vs, rng.uniform(size=(8, 2, 2)).astype(np.float32),
                       maxiter=2, mesh=make_mesh(8))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        nt.nmf_batched(Vs, 2, maxiter=2, mesh=make_mesh(8))


def test_encode_weighted_sharded_matches_single_device():
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(25)
    B, m, n, k = 8, 10, 14, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    for Mw in ((rng.uniform(size=(m, n)) < 0.8).astype(float),
               (rng.uniform(size=(B, m, n)) < 0.8).astype(float)):
        a = nt.nmf_encode(Vs, W, H_init=H0, weights=Mw, divergence="kl",
                          maxiter=8, dtype=np.float64)
        b = nt.nmf_encode(Vs, W, H_init=H0, weights=Mw, divergence="kl",
                          maxiter=8, dtype=np.float64, mesh=make_mesh(8))
        np.testing.assert_allclose(a.H, b.H, atol=1e-10)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)


def test_cmfwisa_encode_matches_fixed_w_single():
    """cmfwisa_encode per-problem trajectories pin against
    cmfwisa(V, ks, W_init=[W_s], W_fixed=True) — H, P, and cost."""
    rng = np.random.default_rng(30)
    B, m, n, iters = 3, 10, 14, 12
    ks = [2, 3]
    Vs = (rng.uniform(0.1, 1, (B, m, n))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))))
    Ws = [rng.uniform(size=(m, k)) for k in ks]
    H0 = rng.uniform(size=(B, sum(ks), n))
    res = nt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=iters,
                            dtype=np.complex128)
    assert res.H[0].shape == (B, ks[0], n) and res.cost.shape == (B, iters)
    assert res.P[0].shape == (B, m, n)
    for b in range(B):
        ref = nt.cmfwisa(Vs[b], ks, W_init=Ws, W_fixed=True,
                         H_init=[H0[b, :ks[0]], H0[b, ks[0]:]],
                         maxiter=iters, tolerance=1e-30,
                         dtype=np.complex128)
        for s in range(2):
            np.testing.assert_allclose(res.W[s], ref.W[s], atol=1e-12)
            np.testing.assert_allclose(res.H[s][b], ref.H[s], atol=1e-9)
            np.testing.assert_allclose(res.P[s][b], ref.P[s], atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_cmfwisa_encode_sparsity_and_pfixed():
    """H_sparsity and per-source P_fixed pin against the single solver."""
    rng = np.random.default_rng(31)
    B, m, n, iters = 2, 8, 12, 10
    ks = [2, 2]
    Vs = (rng.uniform(0.1, 1, (B, m, n))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))))
    Ws = [rng.uniform(size=(m, k)) for k in ks]
    H0 = rng.uniform(size=(B, 4, n))
    P0 = [np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))),
          np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n)))]
    res = nt.cmfwisa_encode(Vs, Ws, H_init=H0, P_init=P0,
                            P_fixed=[True, False], H_sparsity=[0.2, 0.0],
                            maxiter=iters, dtype=np.complex128)
    # fixed phase source really stays fixed
    np.testing.assert_allclose(res.P[0], P0[0], atol=1e-12)
    for b in range(B):
        ref = nt.cmfwisa(Vs[b], ks, W_init=Ws, W_fixed=True,
                         H_init=[H0[b, :2], H0[b, 2:]],
                         P_init=[P0[0][b], P0[1][b]],
                         P_fixed=[True, False], H_sparsity=[0.2, 0.0],
                         maxiter=iters, tolerance=1e-30,
                         dtype=np.complex128)
        for s in range(2):
            np.testing.assert_allclose(res.H[s][b], ref.H[s], atol=1e-9)
            np.testing.assert_allclose(res.P[s][b], ref.P[s], atol=1e-9)
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9)


def test_cmfwisa_encode_sharded_and_validation():
    import jax
    import pytest
    rng = np.random.default_rng(32)
    B, m, n, k = 8, 8, 10, 2
    Vs = (rng.uniform(0.1, 1, (B, m, n))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    a = nt.cmfwisa_encode(Vs, W, H_init=H0, maxiter=8, dtype=np.complex128)
    assert a.P.shape == (B, m, n)  # single source: unwrapped
    # MU with a fixed basis stays monotone non-increasing
    assert np.all(np.diff(a.cost, axis=1) <= 1e-6 * np.abs(a.cost[:, :-1]))
    if len(jax.devices()) >= 8:
        from nmf_toolbox_tpu.parallel import make_mesh
        b = nt.cmfwisa_encode(Vs, W, H_init=H0, maxiter=8,
                              dtype=np.complex128, mesh=make_mesh(8))
        np.testing.assert_allclose(a.H, b.H, atol=1e-10)
        np.testing.assert_allclose(a.P, b.P, atol=1e-10)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10)
    with pytest.raises(ValueError, match="B, m, n"):
        nt.cmfwisa_encode(Vs[0], W)
    with pytest.raises(ValueError, match="W_fixed"):
        nt.cmfwisa_encode(Vs, W, W_fixed=True)
    # device_output: P comes back as real planes (real-boundary contract)
    d = nt.cmfwisa_encode(Vs, W, H_init=H0, maxiter=8,
                          dtype=np.complex128, device_output=True)
    assert isinstance(d.H, jax.Array)
    P_re, P_im = d.P
    np.testing.assert_allclose(np.asarray(P_re)[:, 0] +
                               1j * np.asarray(P_im)[:, 0], a.P, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.H), a.H, atol=1e-12)
    with pytest.raises(ValueError, match="divergence"):
        nt.cmfwisa_encode(Vs, W, divergence="kl")
    with pytest.raises(ValueError, match="P_init"):
        nt.cmfwisa_encode(Vs, W, P_init=np.ones((B, m, n)))


def test_cmfwisa_encode_plane_ingest_matches_complex():
    """The device-resident (V_re, V_im) plane ingest produces the same
    trajectories as the complex host-array path (incl. the on-device
    default phase init)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(33)
    B, m, n, k = 3, 8, 10, 2
    Vs = (rng.uniform(0.1, 1, (B, m, n))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(B, k, n))
    a = nt.cmfwisa_encode(Vs, W, H_init=H0, maxiter=10, dtype=np.complex128)
    planes = (jnp.asarray(Vs.real), jnp.asarray(Vs.imag))
    b = nt.cmfwisa_encode(planes, W, H_init=H0, maxiter=10,
                          dtype=np.float64)
    np.testing.assert_allclose(a.H, b.H, atol=1e-12)
    np.testing.assert_allclose(a.P, b.P, atol=1e-12)
    np.testing.assert_allclose(a.cost, b.cost, rtol=1e-12)


def test_nmf2d_encode_matches_fixed_w_single():
    """nmf2d_encode per-problem trajectories pin against
    nmf2d(V, k, T, P, W_init=W, W_fixed=True) across divergences."""
    rng = np.random.default_rng(60)
    B, m, n, k, T, P, iters = 3, 12, 16, 2, 2, 3, 10
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(0.1, 1, (B, k, n, P))
    for div in ("euclidean", "kl", "is"):
        res = nt.nmf2d_encode(Vs, W, P, H_init=H0, divergence=div,
                              maxiter=iters, dtype=np.float64)
        assert res.H.shape == (B, k, n, P)
        for b in range(B):
            ref = nt.nmf2d(Vs[b], k, T, P, W_init=W, W_fixed=True,
                           H_init=H0[b], divergence=div, maxiter=iters,
                           tolerance=1e-30, dtype=np.float64)
            np.testing.assert_allclose(res.W, ref.W, atol=1e-12,
                                       err_msg=div)
            np.testing.assert_allclose(res.H[b], ref.H, atol=1e-9,
                                       err_msg=div)
            np.testing.assert_allclose(res.cost[b], ref.cost, rtol=1e-9,
                                       err_msg=div)


def test_nmf2d_encode_sparsity_sharded_validation():
    import jax
    import pytest
    rng = np.random.default_rng(61)
    B, m, n, k, T, P = 8, 10, 14, 2, 2, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(0.1, 1, (B, k, n, P))
    a = nt.nmf2d_encode(Vs, W, P, H_init=H0, H_sparsity=0.3, maxiter=8,
                        dtype=np.float64)
    ref = nt.nmf2d(Vs[0], k, T, P, W_init=W, W_fixed=True, H_init=H0[0],
                   H_sparsity=0.3, maxiter=8, tolerance=1e-30,
                   dtype=np.float64)
    np.testing.assert_allclose(a.H[0], ref.H, atol=1e-9)
    if len(jax.devices()) >= 8:
        from nmf_toolbox_tpu.parallel import make_mesh
        b = nt.nmf2d_encode(Vs, W, P, H_init=H0, H_sparsity=0.3,
                            maxiter=8, dtype=np.float64,
                            mesh=make_mesh(8))
        np.testing.assert_allclose(np.asarray(a.H), np.asarray(b.H),
                                   atol=1e-10)
    with pytest.raises(ValueError, match="B, m, n"):
        nt.nmf2d_encode(Vs[0], W, P)
    with pytest.raises(ValueError, match="W_fixed"):
        nt.nmf2d_encode(Vs, W, P, W_fixed=True)
    with pytest.raises(ValueError, match="pitch_len"):
        nt.nmf2d_encode(Vs, W, 0)
    with pytest.raises(ValueError, match="weights"):
        nt.nmf2d_encode(Vs, W, P, weights=np.ones((m, n)))
