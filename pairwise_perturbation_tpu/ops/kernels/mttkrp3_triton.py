"""Order-3 f32 MTTKRP as Pallas kernels for NVIDIA GPUs (Triton route).

V (I, J, K) is read as the row-major matrix V2 (I*J, K), once per call:

- modes 0 and 1: ``rows`` computes T = V2 @ C (I*J, R) on row tiles, the
  K reduction a loop inside each program; XLA then folds T with the
  remaining factor (T is R/K of V).
- mode 2: ``kr`` computes M = (A kr B)^T V2, the Khatri-Rao rows built on
  the fly from gathered factor rows; each program reduces one chunk of
  rows into an (R, K-tile) partial, and XLA sums the chunk partials.

Dots run in IEEE f32 (``Precision.HIGHEST``), never TF32. The rank is
padded to 16 lanes (Triton's smallest dot width). ``interpret=True`` runs
the same kernels on the CPU for tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_HIGHEST = jax.lax.Precision.HIGHEST


def _rows_kernel(v_ref, c_ref, o_ref, *, n_rows, n_k, block_rows, block_k):
    rows = pl.program_id(0) * block_rows + jnp.arange(block_rows)
    row_ok = rows < n_rows
    lanes = jnp.arange(c_ref.shape[1])

    def body(t, acc):
        ks = t * block_k + jnp.arange(block_k)
        k_ok = ks < n_k
        v = plgpu.load(v_ref.at[rows[:, None], ks[None, :]],
                       mask=row_ok[:, None] & k_ok[None, :], other=0.0)
        c = plgpu.load(c_ref.at[ks[:, None], lanes[None, :]],
                       mask=k_ok[:, None], other=0.0)
        return acc + pl.dot(v, c, precision=_HIGHEST)

    acc = jax.lax.fori_loop(
        0, pl.cdiv(n_k, block_k), body,
        jnp.zeros((block_rows, c_ref.shape[1]), jnp.float32))
    plgpu.store(o_ref.at[rows[:, None], lanes[None, :]], acc,
                mask=row_ok[:, None])


def _kr_kernel(v_ref, a_ref, b_ref, o_ref, *, n_rows, n_j, n_k, chunk_rows,
               block_rows, block_k):
    chunk, kt = pl.program_id(0), pl.program_id(1)
    ks = kt * block_k + jnp.arange(block_k)
    k_ok = ks < n_k
    lanes = jnp.arange(a_ref.shape[1])

    def body(s, acc):
        rows = chunk * chunk_rows + s * block_rows + jnp.arange(block_rows)
        row_ok = rows < n_rows
        i, j = rows // n_j, rows % n_j
        w = plgpu.load(a_ref.at[i[:, None], lanes[None, :]],
                       mask=row_ok[:, None], other=0.0) \
            * plgpu.load(b_ref.at[j[:, None], lanes[None, :]],
                         mask=row_ok[:, None], other=0.0)
        v = plgpu.load(v_ref.at[rows[:, None], ks[None, :]],
                       mask=row_ok[:, None] & k_ok[None, :], other=0.0)
        return acc + pl.dot(w, v, trans_a=True, precision=_HIGHEST)

    acc = jax.lax.fori_loop(
        0, chunk_rows // block_rows, body,
        jnp.zeros((a_ref.shape[1], block_k), jnp.float32))
    plgpu.store(o_ref.at[chunk, lanes[:, None], ks[None, :]], acc,
                mask=k_ok[None, :])


def _pad_rank(W, lanes):
    return jnp.pad(W, ((0, 0), (0, lanes - W.shape[1])))


@partial(jax.jit, static_argnames=("mode", "block_rows", "block_k",
                                   "chunk_rows", "interpret"))
def mttkrp3(V, Ws, mode: int, *, block_rows: int = 64, block_k: int = 64,
            chunk_rows: int = 2048, interpret: bool = False):
    """M[i_mode, r] = sum V * prod_{j != mode} W_j for an order-3 f32 V."""
    I, J, K = V.shape
    R = Ws[0].shape[1]
    lanes = max(16, pl.next_power_of_2(R))
    V2 = V.reshape(I * J, K)
    n_rows = I * J
    params = plgpu.CompilerParams(num_warps=4, num_stages=3)
    if mode in (0, 1):
        T = pl.pallas_call(
            partial(_rows_kernel, n_rows=n_rows, n_k=K,
                    block_rows=block_rows, block_k=block_k),
            out_shape=jax.ShapeDtypeStruct((n_rows, lanes), jnp.float32),
            grid=(pl.cdiv(n_rows, block_rows),),
            backend="triton", compiler_params=params, interpret=interpret,
            name="mttkrp3_rows")(V2, _pad_rank(Ws[2], lanes))
        T = T[:, :R].reshape(I, J, R)
        spec, W = ("ijr,jr->ir", Ws[1]) if mode == 0 else ("ijr,ir->jr",
                                                            Ws[0])
        return jnp.einsum(spec, T, W, precision=_HIGHEST)
    chunk_rows = min(chunk_rows, pl.cdiv(n_rows, block_rows) * block_rows)
    P = pl.pallas_call(
        partial(_kr_kernel, n_rows=n_rows, n_j=J, n_k=K,
                chunk_rows=chunk_rows, block_rows=block_rows,
                block_k=block_k),
        out_shape=jax.ShapeDtypeStruct(
            (pl.cdiv(n_rows, chunk_rows), lanes, K), jnp.float32),
        grid=(pl.cdiv(n_rows, chunk_rows), pl.cdiv(K, block_k)),
        backend="triton", compiler_params=params, interpret=interpret,
        name="mttkrp3_kr")(V2, _pad_rank(Ws[0], lanes),
                           _pad_rank(Ws[1], lanes))
    return jnp.sum(P, axis=0)[:R].T
