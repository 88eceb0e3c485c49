"""Regression tests for the round-2 code-review findings."""
import json
import numpy as np
import pytest

import nmf_toolbox_tpu as nt
from tests.test_cli import run_cli


def _lowrank(m, n, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 1.0, (m, r)) @ rng.gamma(0.5, 1.0, (r, n))
            + 0.01).astype(np.float32)


def test_checkpointed_run_with_nndsvd_init(tmp_path):
    # finding 1: run_checkpointed re-passed init= alongside the restored
    # W_init/H_init from chunk 2 on, which the solver rejects
    from nmf_toolbox_tpu.utils.checkpoint import run_checkpointed
    V = _lowrank(50, 40, 4)
    path = tmp_path / "ckpt.npz"
    res = run_checkpointed(nt.nmf, V, 4, total_iters=12, chunk=5,
                           path=path, init="nndsvdar", tolerance=1e-30)
    assert res.n_iters >= 1 and len(res.cost) >= 10


def test_nndsvd_k_exceeds_rank_raises():
    # finding 2: k > min(m, n) silently truncated the components
    from nmf_toolbox_tpu.utils import nndsvd
    V = _lowrank(60, 40, 4)
    with pytest.raises(ValueError, match="k <= min"):
        nndsvd(V, 45)
    with pytest.raises(ValueError, match="k <= min"):
        nt.nmf_hals(V, 45, init="nndsvdar")


def test_weighted_zero_entries_tolerate_nan_data():
    # finding 3: 0 * NaN = NaN leaked through the weighted fields
    rng = np.random.default_rng(3)
    V = _lowrank(40, 30, 4, seed=1).astype(np.float64)
    M = (rng.uniform(size=V.shape) < 0.8).astype(np.float64)
    V_nan = np.where(M > 0, V, np.nan)  # NaN exactly at missing entries
    for div in ("euclidean", "kl", "is", "ab"):
        kw = {"alpha": 0.7, "beta": 0.8} if div == "ab" else {}
        r = nt.nmf(V_nan, 4, weights=M, divergence=div, maxiter=5,
                   tolerance=1e-300, dtype="float64", seed=4, **kw)
        assert np.all(np.isfinite(r.W)), div
        assert np.all(np.isfinite(r.H)), div
        assert np.all(np.isfinite(r.cost)), div


def test_hals_weights_supported_but_guarded():
    # finding 5 history: nmf_hals once silently ignored weights=, then
    # rejected them; round 3 implements weighted rank-1 sweeps.  The
    # unsupported COMBINATIONS must still be loud.
    V = _lowrank(30, 20, 3)
    r = nt.nmf_hals(V, 3, weights=np.ones_like(V), maxiter=3, seed=0)
    assert np.all(np.isfinite(np.asarray(r.cost)[:r.n_iters]))
    with pytest.raises(ValueError, match="extrapolate"):
        nt.nmf_hals(V, 3, weights=np.ones_like(V), extrapolate=True)
    with pytest.raises(ValueError, match="inner_iters"):
        nt.nmf_hals(V, 3, weights=np.ones_like(V), inner_iters=3)


def test_cli_streaming_init_and_inner_flags(matrix_file, tmp_path):
    # findings 4 + 6: --inner-iters silently ignored with --streaming;
    # --init random spuriously rejected with --streaming
    out = str(tmp_path / "f.npz")
    r = run_cli(["nmf", matrix_file, "--k", "4", "--streaming",
                 "--inner-iters", "4", "--out", out])
    assert r.returncode == 2 and "--inner-iters" in r.stderr
    r = run_cli(["nmf", matrix_file, "--k", "4", "--streaming",
                 "--init", "random", "--maxiter", "3", "--out", out])
    assert r.returncode == 0, r.stderr


# reuse the CLI test fixture
from tests.test_cli import matrix_file  # noqa: E402,F401


def test_hull_and_nndsvd_rank_deficient_input():
    # round-2 follow-up: exactly rank-deficient inputs (duplicated rows)
    # made the Cholesky-QR subspace iterates go NaN, and NaN projections
    # reaching the native 2-D hull corrupted the heap.  Both layers are
    # now guarded; everything must stay finite.
    import jax.numpy as jnp
    from nmf_toolbox_tpu.utils.init import (_randomized_spectrum,
                                            convex_hull_anchors, nndsvd,
                                            _convhull_2d)
    V = _lowrank(60, 40, 5)
    Vb = np.vstack([V] * 20)  # m = 1200 > the exact-path cutoff
    _, vecs, _ = _randomized_spectrum(jnp.asarray(Vb), 16, 0, 4)
    assert bool(jnp.all(jnp.isfinite(vecs)))
    S = convex_hull_anchors(Vb, seed=1)
    assert np.all(np.isfinite(np.asarray(S)))
    W, H = nndsvd(Vb, 8)
    assert np.all(np.isfinite(np.asarray(W)))
    # the hull guard itself: non-finite points are excluded, indices map
    # back to the original positions
    pts = np.array([[0.0, 0.0], [np.nan, 1.0], [1.0, 0.0], [1.0, 1.0],
                    [0.5, np.inf], [0.0, 1.0]])
    idx = _convhull_2d(pts)
    assert set(idx) == {0, 2, 3, 5}


# ---------------------------------------------------------------- round 4


def test_save_factors_initializes_no_backend(tmp_path):
    # The multi-process guard once called jax.process_count(), which
    # forces backend init.  The npz save must stay pure host-side: no
    # backend may exist after the call.
    import subprocess, sys
    src = (
        "import numpy as np, sys\n"
        "from nmf_toolbox_tpu.utils.checkpoint import save_factors\n"
        "save_factors(sys.argv[1], {'W': np.ones((3, 2)),"
        " 'H': np.ones((2, 4))})\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, list(xla_bridge._backends)\n"
        "print('no-backend-ok')\n")
    p = subprocess.run(
        [sys.executable, "-c", src, str(tmp_path / "f.npz")],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "no-backend-ok" in p.stdout
    assert (tmp_path / "f.npz").exists()


def test_save_factors_multiprocess_guard(tmp_path, monkeypatch):
    # ...and the guard fires under jax.distributed ONLY for leaves that
    # are not fully addressable (round-5 advice: plain numpy / gathered
    # host arrays must keep saving — the standard "gather to host, save
    # on process 0" pattern).
    from jax._src import distributed as jdist
    from nmf_toolbox_tpu.utils.checkpoint import save_factors
    monkeypatch.setattr(jdist.global_state, "num_processes", 2,
                        raising=False)
    # host numpy payload: proceeds
    save_factors(str(tmp_path / "ok.npz"), {"W": np.ones((2, 2))})
    assert (tmp_path / "ok.npz").exists()

    class _ShardedStub(np.ndarray):
        # numpy subclass so np.asarray would "work" (silently writing
        # only local data) if the guard missed it
        is_fully_addressable = False

    bad = np.ones((2, 2)).view(_ShardedStub)
    with pytest.raises(RuntimeError, match="single-host only"):
        save_factors(str(tmp_path / "g.npz"), {"W": bad})


def test_separate_waveforms_shape_mismatch_message():
    # round-4 finding 4: mismatched factors raised a cryptic XLA
    # broadcast error from inside jit instead of separate()'s ValueError
    rng = np.random.default_rng(0)
    Z = np.stack([rng.normal(size=(9, 20)), rng.normal(size=(9, 20))]
                 ).astype(np.float32)
    W = [rng.uniform(size=(9, 3)).astype(np.float32)]
    H = [rng.uniform(size=(3, 17)).astype(np.float32)]  # wrong frames
    with pytest.raises(ValueError, match="factors reconstruct"):
        nt.separate_waveforms(Z, W, H, hop_length=4)


def test_magnitude_planes_exported_and_jitted():
    # round-4 finding 5: the planar magnitude was re-implemented at four
    # call sites; it is now nt.magnitude(..., planes=True), one dispatch
    rng = np.random.default_rng(1)
    P = rng.normal(size=(2, 5, 7)).astype(np.float32)
    got = np.asarray(nt.magnitude(P, planes=True))
    np.testing.assert_allclose(got, np.hypot(P[0], P[1]), rtol=1e-6)
    got2 = np.asarray(nt.magnitude(P, power=2.0, planes=True))
    np.testing.assert_allclose(got2, np.hypot(P[0], P[1]) ** 2, rtol=1e-5)


def test_solver_marginal_sweep_flag_only_argv():
    # round-4 finding 3: `solver_marginal_sweep.py --small` crashed with
    # KeyError('--small'); flags must not be eaten as the bench selector
    import pathlib, subprocess, sys
    script = pathlib.Path(__file__).resolve().parents[1] \
        / "benchmarks" / "solver_marginal_sweep.py"
    p = subprocess.run(
        [sys.executable, str(script), "definitely-not-a-bench", "--small"],
        capture_output=True, text=True, timeout=60)
    assert p.returncode == 2
    assert "unknown bench" in p.stderr
