"""utils/debug.emulate_tf32_matmul_numerics: the CPU-side emulation of
the GPU's default-precision float32 matmul (TF32 operands, float32
accumulation) used to calibrate chip_smoke.py's golden thresholds
without a GPU.
"""
import numpy as np
import jax
import jax.numpy as jnp

from nmf_toolbox_tpu.utils.debug import emulate_tf32_matmul_numerics


def _operands():
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(64, 64)), jnp.float32)
    B = jnp.asarray(rng.normal(size=(64, 64)), jnp.float32)
    return A, B


def _tf32(x):
    """Independent TF32 rounding: nearest-even to a 10-bit mantissa."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def test_emulation_rounds_default_precision_dots_only():
    A, B = _operands()
    ref = np.asarray(A) @ np.asarray(B)
    expect = _tf32(A) @ _tf32(B)
    with emulate_tf32_matmul_numerics():
        emu = np.asarray(jax.jit(lambda a, b: a @ b)(A, B))
        ein = np.asarray(jax.jit(
            lambda a, b: jnp.einsum("ij,jk->ik", a, b))(A, B))
        hi = np.asarray(jax.jit(lambda a, b: jax.lax.dot(
            a, b, precision="highest"))(A, B))
    scale = np.max(np.abs(ref))
    # default-precision dots get the card's rounding ...
    assert np.max(np.abs(emu - ref)) / scale > 1e-5, "emulation was a no-op"
    assert np.max(np.abs(ein - ref)) / scale > 1e-5, "einsum path missed"
    # ... matching the independent TF32 expectation up to float32
    # accumulation order
    assert np.max(np.abs(emu - expect)) / scale < 1e-6, "wrong error model"
    # explicitly raised precision stays full float32
    assert np.max(np.abs(hi - ref)) / scale < 1e-6, "highest-precision hit"


def test_emulation_composes_with_loops_and_restores_on_exit():
    A, B = _operands()
    ref = np.asarray(A) @ np.asarray(B)
    scale = np.max(np.abs(ref))
    # trace this shape before entry: jnp's internal jaxpr caches must not
    # let a pre-traced matmul bypass the emulation inside the context
    np.asarray(jax.jit(lambda a, b: a @ b)(A, B))

    def body(c, _):
        return (c[0], c[0] @ c[1]), None

    with emulate_tf32_matmul_numerics():
        pre = np.asarray(jax.jit(lambda a, b: a @ b)(A, B))
        (_, scanned), _ = jax.jit(
            lambda a, b: jax.lax.scan(body, (a, b), None, length=1))(A, B)
    clean = np.asarray(jax.jit(lambda a, b: (a @ b) * 1)(A, B))
    assert np.max(np.abs(pre - ref)) / scale > 1e-5, "pre-traced bypass"
    assert np.max(np.abs(np.asarray(scanned) - pre)) / scale < 1e-6
    # context exit restores plain float32
    assert np.max(np.abs(clean - ref)) / scale < 1e-6, "leaked after exit"
