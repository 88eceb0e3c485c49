"""Crash-resume equivalence: a checkpointed run interrupted and resumed
must produce exactly the factors of an uninterrupted run."""
import numpy as np

import nmf_toolbox_tpu as nt
from nmf_toolbox_tpu.utils.checkpoint import run_checkpointed


def test_chunked_equals_continuous(tmp_path):
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 1, (30, 40))
    W0 = rng.uniform(size=(30, 4))
    H0 = rng.uniform(size=(4, 40))
    # continuous 40-iteration run
    ref = nt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=40, tolerance=1e-30,
                 dtype=np.float64)
    # chunked 4 x 10 with checkpoints
    p = tmp_path / "run.npz"
    res = run_checkpointed(nt.nmf, V, 4, total_iters=40, chunk=10, path=p,
                           W_init=W0, H_init=H0, tolerance=1e-30,
                           dtype=np.float64)
    np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-12)
    assert len(res.cost) == 40


def test_crash_resume(tmp_path):
    rng = np.random.default_rng(1)
    V = rng.uniform(0.1, 1, (25, 30))
    W0 = rng.uniform(size=(25, 3))
    H0 = rng.uniform(size=(3, 30))
    p = tmp_path / "run.npz"
    # "crash" after 2 chunks: run only 20 of 60 iterations
    run_checkpointed(nt.nmf, V, 3, total_iters=20, chunk=10, path=p,
                     W_init=W0, H_init=H0, tolerance=1e-30, dtype=np.float64)
    # resume to 60 total (fresh process semantics: only the path survives)
    res = run_checkpointed(nt.nmf, V, 3, total_iters=60, chunk=10, path=p,
                           W_init=W0, H_init=H0, tolerance=1e-30,
                           dtype=np.float64)
    ref = nt.nmf(V, 3, W_init=W0, H_init=H0, maxiter=60, tolerance=1e-30,
                 dtype=np.float64)
    np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-12)
    assert len(res.cost) == 60


def test_convergence_stops_chunking(tmp_path):
    rng = np.random.default_rng(2)
    V = rng.uniform(0.1, 1, (20, 25))
    res = run_checkpointed(nt.nmf, V, 3, total_iters=500, chunk=100,
                           path=tmp_path / "c.npz", tolerance=1e-2,
                           seed=3, dtype=np.float64)
    assert res.converged
    assert len(res.cost) < 500


def test_resume_when_already_complete(tmp_path):
    """Re-invoking a finished checkpointed run must return the saved state,
    not crash (regression: returned None and callers dereferenced .cost)."""
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1, (15, 20))
    p = tmp_path / "done.npz"
    a = run_checkpointed(nt.nmf, V, 3, total_iters=8, chunk=4, path=p,
                         seed=1, tolerance=1e-30, dtype=np.float64)
    b = run_checkpointed(nt.nmf, V, 3, total_iters=8, chunk=4, path=p,
                         seed=1, tolerance=1e-30, dtype=np.float64)
    assert b.converged
    np.testing.assert_allclose(b.W, a.W, atol=1e-12)
    assert b.final_cost > 0


def test_chunk_of_one_early_stops(tmp_path):
    """chunk=1 must still honor the tolerance (the device loop can never
    compare across its own chunk; the driver checks at the boundary)."""
    rng = np.random.default_rng(4)
    V = rng.uniform(0.1, 1, (20, 25))
    res = run_checkpointed(nt.nmf, V, 3, total_iters=300, chunk=1,
                           path=tmp_path / "one.npz", tolerance=1e-2,
                           seed=3, dtype=np.float64)
    ref = nt.nmf(V, 3, maxiter=300, tolerance=1e-2, seed=3, dtype=np.float64)
    assert res.converged
    # stops within one chunk of the continuous run's stopping point
    assert abs(len(res.cost) - len(ref.cost)) <= 1


def test_total_iterations_reported(tmp_path):
    rng = np.random.default_rng(5)
    V = rng.uniform(0.1, 1, (15, 18))
    res = run_checkpointed(nt.nmf, V, 2, total_iters=12, chunk=4,
                           path=tmp_path / "t.npz", tolerance=1e-30,
                           seed=1, dtype=np.float64)
    assert res.n_iters == 12 and len(res.cost) == 12


def test_chunked_cnmf_exact(tmp_path):
    """cnmf is memoryless across iterations -> chunked == continuous."""
    rng = np.random.default_rng(6)
    V = rng.uniform(0.1, 1, (16, 30))
    W0 = rng.uniform(0.1, 1, (16, 3, 2))
    H0 = rng.uniform(0.1, 1, (3, 30))
    ref = nt.cnmf(V, 3, 2, W_init=W0, H_init=H0, maxiter=18,
                  tolerance=1e-30, dtype=np.float64)
    res = run_checkpointed(nt.cnmf, V, 3, 2, total_iters=18, chunk=6,
                           path=tmp_path / "c.npz", W_init=W0, H_init=H0,
                           tolerance=1e-30, dtype=np.float64)
    np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-12)
    np.testing.assert_allclose(res.cost, ref.cost, rtol=1e-12)


def test_chunked_nmfsc_bit_exact(tmp_path):
    """Chunked nmfsc must be bit-identical to
    single-dispatch — requires the line-search stepsizes (nmfsc.m:147,178)
    to ride through Result.resume_state and the checkpoint file."""
    rng = np.random.default_rng(7)
    V = rng.uniform(0.1, 1, (30, 40))
    W0 = rng.uniform(size=(30, 4))
    H0 = rng.uniform(size=(4, 40))
    H0 = H0 / np.sqrt((H0**2).sum(1, keepdims=True))
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, tolerance=1e-30,
              dtype=np.float64)
    ref = nt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=24, **kw)
    res = run_checkpointed(nt.nmfsc, V, 4, total_iters=24, chunk=7,
                           path=tmp_path / "sc.npz", W_init=W0, H_init=H0,
                           **kw)
    np.testing.assert_array_equal(res.W, ref.W)
    np.testing.assert_array_equal(res.H, ref.H)
    np.testing.assert_array_equal(np.asarray(res.cost),
                                  np.asarray(ref.cost))


def test_chunked_nmfsc_crash_resume_bit_exact(tmp_path):
    """Fresh-process resume: stepsize state must come back from the npz."""
    rng = np.random.default_rng(8)
    V = rng.uniform(0.1, 1, (25, 30))
    W0 = rng.uniform(size=(25, 3))
    H0 = rng.uniform(size=(3, 30))
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, tolerance=1e-30,
              dtype=np.float64)
    p = tmp_path / "sc.npz"
    run_checkpointed(nt.nmfsc, V, 3, total_iters=10, chunk=5, path=p,
                     W_init=W0, H_init=H0, **kw)
    res = run_checkpointed(nt.nmfsc, V, 3, total_iters=30, chunk=5, path=p,
                           W_init=W0, H_init=H0, **kw)
    ref = nt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=30, **kw)
    np.testing.assert_array_equal(res.W, ref.W)
    np.testing.assert_array_equal(res.H, ref.H)


def test_chunked_cnmfsc_bit_exact(tmp_path):
    """cnmfsc carries a PER-FRAME stepsize vector plus the W0 double
    buffer (cnmfsc.m:147,266); chunked must still be bit-identical."""
    rng = np.random.default_rng(9)
    V = rng.uniform(0.1, 1, (20, 28))
    W0 = rng.uniform(size=(20, 3, 3))
    H0 = rng.uniform(size=(3, 28))
    H0 = H0 / np.sqrt((H0**2).sum(1, keepdims=True))
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, tolerance=1e-30,
              dtype=np.float64)
    ref = nt.cnmfsc(V, 3, 3, W_init=W0, H_init=H0, maxiter=18, **kw)
    res = run_checkpointed(nt.cnmfsc, V, 3, 3, total_iters=18, chunk=5,
                           path=tmp_path / "csc.npz", W_init=W0, H_init=H0,
                           **kw)
    np.testing.assert_array_equal(res.W, ref.W)
    np.testing.assert_array_equal(res.H, ref.H)
    np.testing.assert_array_equal(np.asarray(res.cost),
                                  np.asarray(ref.cost))


def test_manual_resume_state_round_trip():
    """The resume_state surface is public: a two-call manual continuation
    reproduces the single-call trajectory exactly."""
    rng = np.random.default_rng(10)
    V = rng.uniform(0.1, 1, (22, 26))
    W0 = rng.uniform(size=(22, 3))
    H0 = rng.uniform(size=(3, 26))
    kw = dict(W_sparsity=0.5, H_sparsity=0.5, tolerance=1e-30,
              dtype=np.float64)
    ref = nt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=12, **kw)
    a = nt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=5, **kw)
    b = nt.nmfsc(V, 3, W_init=a.W, H_init=a.H, maxiter=7,
                 resume_state=a.resume_state, **kw)
    np.testing.assert_array_equal(b.W, ref.W)
    np.testing.assert_array_equal(b.H, ref.H)


def test_chunked_nmf2d_exact(tmp_path):
    """nmf2d is memoryless across iterations -> chunked == continuous.

    Entry normalization is idempotent on an already-normalized resumed
    basis, so the cross-frame renorm at each chunk entry is harmless."""
    rng = np.random.default_rng(7)
    V = rng.uniform(0.1, 1, (14, 24))
    W0 = rng.uniform(0.1, 1, (14, 2, 2))
    H0 = rng.uniform(0.1, 1, (2, 24, 3))
    ref = nt.nmf2d(V, 2, 2, 3, W_init=W0, H_init=H0, maxiter=15,
                   tolerance=1e-30, dtype=np.float64)
    res = run_checkpointed(nt.nmf2d, V, 2, 2, 3, total_iters=15, chunk=5,
                           path=tmp_path / "d.npz", W_init=W0, H_init=H0,
                           tolerance=1e-30, dtype=np.float64)
    np.testing.assert_allclose(res.W, ref.W, atol=1e-12)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-12)


def test_chunked_symnmf_exact(tmp_path):
    rng = np.random.default_rng(8)
    B = rng.uniform(0.1, 1, (18, 3))
    A = B @ B.T + 0.05 * rng.uniform(size=(18, 18))
    A = (A + A.T) / 2
    H0 = rng.uniform(0.1, 1, (18, 3))
    ref = nt.symnmf(A, 3, H_init=H0, maxiter=15, tolerance=1e-30,
                    dtype=np.float64)
    res = run_checkpointed(nt.symnmf, A, 3, total_iters=15, chunk=5,
                           path=tmp_path / "s.npz", H_init=H0,
                           tolerance=1e-30, dtype=np.float64)
    np.testing.assert_allclose(res.H, ref.H, atol=1e-12)
