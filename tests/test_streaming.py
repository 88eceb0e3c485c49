"""Out-of-core streaming NMF tests."""
import numpy as np

import nmf_toolbox_tpu as nt


def _lowrank(rng, m, n, k):
    return (rng.gamma(2.0, 1.0, (m, k)) @ rng.gamma(0.6, 1.0, (k, n))
            + 0.01).astype(np.float32)


def test_streaming_approximates_batch():
    rng = np.random.default_rng(0)
    V = _lowrank(rng, 60, 400, 5)
    batch = nt.nmf(V, 5, maxiter=80, tolerance=1e-30, seed=1,
                   dtype=np.float64)
    stream = nt.nmf_streaming(V, 5, block_size=64, epochs=10,
                              return_H=True, seed=1)
    rel_b = np.linalg.norm(V - batch.W @ batch.H) / np.linalg.norm(V)
    rel_s = np.linalg.norm(V - stream.W @ stream.H) / np.linalg.norm(V)
    assert stream.W.shape == (60, 5) and stream.H.shape == (5, 400)
    assert rel_s < max(2.5 * rel_b, 0.08)  # same ballpark as batch
    c = np.asarray(stream.cost)
    assert c[-1] < c[0]


def test_streaming_from_memmap(tmp_path):
    """Out-of-core source: a memory-mapped .npy never fully loaded."""
    rng = np.random.default_rng(1)
    V = _lowrank(rng, 40, 900, 4)
    p = tmp_path / "big.npy"
    np.save(p, V)
    Vmm = np.load(p, mmap_mode="r")
    res = nt.nmf_streaming(Vmm, 4, block_size=128, epochs=6, seed=2)
    assert res.H is None  # not materialized unless asked
    rel = None
    enc = nt.nmf(V, 4, W_init=res.W, W_fixed=True, maxiter=50,
                 tolerance=1e-30, dtype=np.float64)
    rel = np.linalg.norm(V - np.asarray(enc.W) @ np.asarray(enc.H)) / np.linalg.norm(V)
    assert rel < 0.1


def test_streaming_early_stop():
    rng = np.random.default_rng(2)
    V = _lowrank(rng, 30, 200, 3)
    res = nt.nmf_streaming(V, 3, block_size=64, epochs=50, tolerance=1.0,
                           seed=3)
    assert res.converged and res.n_iters < 50


def test_streaming_single_block():
    """block_size >= n degenerates to full-batch online updates."""
    rng = np.random.default_rng(3)
    V = _lowrank(rng, 20, 50, 3)
    res = nt.nmf_streaming(V, 3, block_size=512, epochs=8, seed=1,
                           return_H=True)
    assert res.H.shape == (3, 50)
    c = np.asarray(res.cost)
    assert c[-1] < c[0] and np.all(np.isfinite(c))


def test_streaming_mesh_matches_single_device(tmp_path):
    """The out-of-core path composes with multi-chip — a
    mesh-sharded streamed run is (tolerance-)identical to the
    single-device streamed run, on a memmap with a non-divisible tail
    block and non-divisible m."""
    import jax
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(3)
    V = _lowrank(rng, 33, 415, 4).astype(np.float64)  # 415 = 6*64 + 31 tail
    p = tmp_path / "big64.npy"
    np.save(p, V)
    Vmm = np.load(p, mmap_mode="r")
    a = nt.nmf_streaming(Vmm, 4, block_size=64, epochs=4, seed=2,
                         return_H=True, dtype=np.float64)
    for mesh in (make_mesh(8), make_mesh(shape=(2, 4))):
        b = nt.nmf_streaming(Vmm, 4, block_size=64, epochs=4, seed=2,
                             return_H=True, dtype=np.float64, mesh=mesh)
        np.testing.assert_allclose(b.W, a.W, atol=1e-10)
        np.testing.assert_allclose(b.H, a.H, atol=1e-10)
        np.testing.assert_allclose(np.asarray(b.cost), np.asarray(a.cost),
                                   rtol=1e-10)


def test_encode_streaming_exact_vs_in_memory():
    """Streaming encode is EXACT (H columns are independent given W):
    block results equal the in-memory fixed-W run, any divergence."""
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(30)
    m, n, k = 16, 53, 3  # n deliberately not a block multiple
    V = rng.uniform(0.1, 1, (m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    for div in ("euclidean", "kl"):
        res = nt.nmf_encode_streaming(V, W, H_init=H0, block_size=17,
                                      divergence=div, maxiter=9,
                                      dtype=np.float64)
        ref = nt.nmf(V, k, W_init=W, W_fixed=True, H_init=H0,
                     divergence=div, maxiter=9, tolerance=1e-30,
                     dtype=np.float64)
        np.testing.assert_allclose(res.H, ref.H, atol=1e-9, err_msg=div)
        np.testing.assert_allclose(res.cost, ref.cost, rtol=1e-9,
                                   err_msg=div)


def test_encode_streaming_mmap_and_out(tmp_path):
    """Memory-mapped input + in-place memmap output: nothing larger than
    a block materializes."""
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(31)
    m, n, k = 12, 40, 2
    V = rng.uniform(0.1, 1, (m, n)).astype(np.float32)
    p = tmp_path / "V.npy"
    np.save(p, V)
    Vmm = np.load(p, mmap_mode="r")
    W = rng.uniform(size=(m, k)).astype(np.float32)
    out = np.lib.format.open_memmap(tmp_path / "H.npy", mode="w+",
                                    dtype=np.float32, shape=(k, n))
    res = nt.nmf_encode_streaming(Vmm, W, block_size=16, maxiter=8,
                                  seed=2, out=out)
    assert res.H is out
    out.flush()
    H = np.load(tmp_path / "H.npy")
    assert np.all(np.isfinite(H)) and H.shape == (k, n)
    rel = np.linalg.norm(V - np.asarray(res.W) @ H) / np.linalg.norm(V)
    assert rel < 0.6  # random dictionary: just sanity


def test_encode_streaming_weighted_and_validation():
    import pytest
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(32)
    m, n, k = 10, 30, 2
    V = rng.uniform(0.1, 1, (m, n))
    W = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    M = (rng.uniform(size=(m, n)) < 0.8).astype(float)
    res = nt.nmf_encode_streaming(V, W, H_init=H0, weights=M,
                                  block_size=13, divergence="kl",
                                  maxiter=6, dtype=np.float64)
    ref = nt.nmf(V, k, W_init=W, W_fixed=True, H_init=H0, weights=M,
                 divergence="kl", maxiter=6, tolerance=1e-30,
                 dtype=np.float64)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-9)
    np.testing.assert_allclose(res.cost, ref.cost, rtol=1e-9)
    with pytest.raises(ValueError, match="out must be"):
        nt.nmf_encode_streaming(V, W, out=np.zeros((k, n + 1)), maxiter=2)
    with pytest.raises(ValueError, match="single-device"):
        from nmf_toolbox_tpu.parallel import make_mesh
        nt.nmf_encode_streaming(V, W, mesh=make_mesh(1), maxiter=2)
