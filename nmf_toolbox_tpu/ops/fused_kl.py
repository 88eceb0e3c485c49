"""KL W-phase ``(V / (W @ H)) @ H'`` as one Pallas kernel (Triton route).

The naive KL step writes the m-by-n reconstruction ``W @ H`` and the
ratio field ``V / (W @ H)`` to device memory and reads both back.  This
kernel keeps them in registers: each program owns ``block_m`` rows, walks
the columns in ``block_n`` tiles, rebuilds the reconstruction tile from
its W rows and the H tile, and accumulates ``ratio @ H_tile'`` into a
``(block_m, k)`` sum.  Nothing carries between programs, so the row
blocks run in any order.  Device-memory traffic is one read of V plus
the factors.

Blocks of 128 rows by 64 columns with 8 warps were the fastest of six
tilings at 40k x 10k rank 100 on an H100 (benchmarks/kl_wphase_compare.py);
128 x 128 exceeds the shared memory.  ``models/nmf.py`` reaches this
through ``method='fused'``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _kernel(V_ref, W_ref, H_ref, out_ref, *, m, n, k, block_m, block_n, kp):
    rows = pl.program_id(0) * block_m + jnp.arange(block_m)
    ks = jnp.arange(kp)
    row_ok = rows < m
    k_ok = ks < k
    w_mask = row_ok[:, None] & k_ok[None, :]
    W_blk = plgpu.load(W_ref.at[rows[:, None], ks[None, :]], mask=w_mask,
                       other=0.0)

    def body(j, acc):
        cols = j * block_n + jnp.arange(block_n)
        col_ok = cols < n
        H_t = plgpu.load(H_ref.at[ks[:, None], cols[None, :]],
                         mask=k_ok[:, None] & col_ok[None, :], other=0.0)
        v_mask = row_ok[:, None] & col_ok[None, :]
        V_t = plgpu.load(V_ref.at[rows[:, None], cols[None, :]],
                         mask=v_mask, other=0.0)
        V_hat = pl.dot(W_blk, H_t)
        ratio = jnp.where(v_mask, V_t / jnp.where(v_mask, V_hat, 1.0), 0.0)
        return acc + pl.dot(ratio, H_t, trans_b=True)

    acc = jax.lax.fori_loop(0, pl.cdiv(n, block_n), body,
                            jnp.zeros((block_m, kp), jnp.float32))
    plgpu.store(out_ref.at[rows[:, None], ks[None, :]], acc, mask=w_mask)


@functools.partial(jax.jit, static_argnames=("block_m", "block_n",
                                             "num_warps", "num_stages",
                                             "interpret"))
def kl_ratio_dot_ht(V, W, H, *, block_m=128, block_n=64, num_warps=8,
                    num_stages=2, interpret=False):
    """``(V / (W @ H)) @ H'`` for float32 V (m, n), W (m, k), H (k, n).

    ``interpret=True`` runs the Pallas interpreter (CPU tests); on the GPU
    the kernel is compiled through Triton.
    """
    m, n = V.shape
    k = W.shape[1]
    kp = max(_next_pow2(k), 16)
    kernel = functools.partial(_kernel, m=m, n=n, k=k, block_m=block_m,
                               block_n=block_n, kp=kp)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m, k), jnp.float32),
        grid=(pl.cdiv(m, block_m),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="kl_ratio_dot_ht",
    )(V, W, H)
