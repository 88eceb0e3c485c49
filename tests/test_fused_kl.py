"""ops/fused_kl: the KL W-phase kernel in the Pallas interpreter on the
CPU, its wiring behind ``nt.nmf(method="fused")``, and (on a GPU only)
the kernel as Triton compiles it."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import nmf_toolbox_tpu as nt
from nmf_toolbox_tpu.models.nmf import FUSED_MAX_K
from nmf_toolbox_tpu.ops.fused_kl import kl_ratio_dot_ht


def _factors(m, n, k, seed=0):
    kv, kw, kh = jax.random.split(jax.random.PRNGKey(seed), 3)
    V = jax.random.uniform(kv, (m, n), jnp.float32, 0.05, 1.0)
    W = jax.random.uniform(kw, (m, k), jnp.float32, 0.1, 1.0)
    H = jax.random.uniform(kh, (k, n), jnp.float32, 0.1, 1.0)
    return V, W, H


def _reference(V, W, H):
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    return (V / (W @ H)) @ H.T


@pytest.mark.parametrize("m,n,k,tiles", [
    (70, 90, 5, dict(block_m=32, block_n=32)),     # ragged rows and columns
    (128, 64, 16, {}),                             # exact default tiles
    (130, 200, 100, {}),                           # k pads 100 -> 128
    (33, 65, 1, dict(block_m=16, block_n=64)),     # rank 1
])
def test_kernel_matches_reference_in_interpreter(m, n, k, tiles):
    V, W, H = _factors(m, n, k)
    out = kl_ratio_dot_ht(V, W, H, interpret=True, **tiles)
    assert out.shape == (m, k) and out.dtype == jnp.float32
    ref = _reference(V, W, H)
    assert np.max(np.abs(np.asarray(out) - ref)) / np.max(ref) < 1e-5


@pytest.mark.parametrize("kw", [
    {},
    dict(W_sparsity=0.1, H_sparsity=0.2),
    dict(W_fixed=True),
    dict(H_fixed=True),
])
def test_fused_method_matches_naive(kw):
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1.0, (70, 52)).astype(np.float32)
    args = dict(divergence="kl", maxiter=6, seed=4, tolerance=1e-30, **kw)
    a = nt.nmf(V, 6, method="naive", **args)
    b = nt.nmf(V, 6, method="fused", **args)
    for x, y in ((a.W, b.W), (a.H, b.H)):
        assert np.max(np.abs(x - y)) / np.max(np.abs(x)) < 1e-5
    np.testing.assert_allclose(b.cost, a.cost, rtol=1e-5)


def test_fused_method_multi_source():
    rng = np.random.default_rng(4)
    V = rng.uniform(0.1, 1.0, (40, 33)).astype(np.float32)
    args = dict(divergence="kl", maxiter=5, seed=2, tolerance=1e-30,
                W_fixed=[True, False])
    a = nt.nmf(V, [3, 4], method="naive", **args)
    b = nt.nmf(V, [3, 4], method="fused", **args)
    for x, y in zip(a.W + a.H, b.W + b.H):
        assert np.max(np.abs(x - y)) / np.max(np.abs(x)) < 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(divergence="euclidean"), "kl divergence"),
    (dict(divergence="is"), "kl divergence"),
    (dict(divergence="kl", dtype=np.float64), "float32"),
    (dict(divergence="kl", mesh="mesh"), "one device"),
])
def test_fused_method_rejects_unsupported(kw, match):
    from nmf_toolbox_tpu.parallel import make_mesh
    if kw.get("mesh") == "mesh":
        kw = dict(kw, mesh=make_mesh(2, devices=jax.devices()[:2]))
    V = np.random.default_rng(0).uniform(0.1, 1, (16, 12)).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        nt.nmf(V, 2, method="fused", maxiter=2, **kw)


def test_fused_method_rejects_rank_above_tiles():
    V = np.random.default_rng(0).uniform(0.1, 1, (8, 200)).astype(np.float32)
    with pytest.raises(ValueError, match=f"k <= {FUSED_MAX_K}"):
        nt.nmf(V, FUSED_MAX_K + 1, divergence="kl", method="fused",
               maxiter=1)


@pytest.fixture
def gpu_device():
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: the kernel compiles through "
                    "Triton only there")
    return gpus[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_at_real_width(gpu_device):
    with jax.default_device(gpu_device):
        V, W, H = _factors(40_000, 10_000, 100)
        out = kl_ratio_dot_ht(V, W, H)
        with jax.default_matmul_precision("highest"):
            ref = (V / (W @ H)) @ H.T
        dev = float(jnp.max(jnp.abs(out - ref)) / jnp.max(ref))
    assert dev < 1e-3
