"""Sparse (COO) tensor kernels for CP-ALS.

JAX replacement for the reference's ``-issparse`` path, which
threads a sparsity flag into every CTF tensor constructor
(test_ALS.cxx:126-131, 229; run.cxx:137-140) and lets CTF's sparse
contraction engine do the rest. Here the sparse path is explicit:

- storage is static-shape COO (``indices[nnz, N]`` int32, ``values[nnz]``)
  — nnz is a static dimension, so every kernel compiles once per tensor;
- the MTTKRP is a gather of factor rows + a Khatri-Rao product on the
  nonzeros + one ``segment_sum`` scatter-add (atomic adds on a GPU — no
  dynamic shapes anywhere);
- PP pair caches contract the same nonzeros with a fused output index
  (i * s_j + j), yielding the standard dense rank-major caches
  (R, s_i, s_j) — PP sweeps downstream are IDENTICAL to the dense engine
  (als_CP.cxx:753-825), because the caches and factors are dense either
  way. Only cache *builds* touch the sparse tensor.

The natural fit is the Poisson/laplacian tensor family (``-tensor p``),
which is extremely sparse (sum of I x..x D x..x I stencils,
common.cxx:575-642).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class SparseTensor:
    """Static-shape COO tensor: ``indices[nnz, order]``, ``values[nnz]``."""
    indices: jnp.ndarray
    values: jnp.ndarray
    shape: Tuple[int, ...]

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def nnz(self):
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def tree_flatten(self):
        return (self.indices, self.values), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        return cls(children[0], children[1], tuple(shape))


def from_dense(V, tol: float = 0.0) -> SparseTensor:
    """COO from a dense host/device array (entries with |v| > tol)."""
    Vh = np.asarray(V)
    idx = np.argwhere(np.abs(Vh) > tol).astype(np.int32)
    vals = Vh[tuple(idx.T)]
    return SparseTensor(jnp.asarray(idx), jnp.asarray(vals), Vh.shape)


@partial(jax.jit, donate_argnums=0)
def _scatter_dense(out, indices, values):
    return out.at[tuple(indices.T)].add(values)


def to_dense(st: SparseTensor):
    # donated zeros buffer: the scatter updates in place instead of
    # allocating input + output copies (2x the dense size — OOMs the
    # chip for HBM-scale tensors like the 6.4 GB 200^4 bench fixture)
    return _scatter_dense(jnp.zeros(st.shape, st.dtype),
                          st.indices, st.values)


def norm_sq(st: SparseTensor):
    acc = jnp.float32 if st.dtype == jnp.bfloat16 else st.dtype
    return jnp.dot(st.values, st.values, preferred_element_type=acc,
                   precision=jax.lax.Precision.HIGHEST)


# Scatter/gather strategy for the sparse kernels: the native ops (row
# gather, segment_sum — gathers and atomic scatter-adds on a GPU) by
# default, or with ``method="onehot"`` a ONE-HOT MATMUL — M = E^T @ prod
# for the scatter, rows = E @ W for gathers (exact: one product per
# output). The one-hot materializes nnz * s elements; on an H100 it was
# 21x slower than native at the sparse fixture's 1.6M nonzeros
# (chip_smoke.py phase B times both), so it is kept only as an explicit
# choice for parity tests. Atomic scatter-adds sum in a different order on
# every GPU run, so sparse runs there are not bit-reproducible.


def _gather_rows(W, idx, method: str = "native"):
    """W[idx, :] — factor-row gather, natively or as a one-hot matmul.

    The one-hot matmul E @ W computes the SAME rows EXACTLY (each output
    element is a single product 1.0 * W[i, r] at HIGHEST precision — no
    summation, no rounding)."""
    if method == "onehot":
        s = W.shape[0]
        E = (idx[:, None] == jnp.arange(s, dtype=idx.dtype)[None, :])
        return jax.lax.dot_general(
            E.astype(W.dtype), W, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=W.dtype)
    return W[idx, :]


def _gathered_kr(st: SparseTensor, Ws: Sequence, skip: Tuple[int, ...],
                 method: str = "native"):
    """values * prod_{j not in skip} W_j[idx_j, :]  -> (nnz, R)."""
    R = Ws[0].shape[1]
    prod = st.values[:, None] * jnp.ones((1, R), Ws[0].dtype)
    for j in range(st.ndim):
        if j in skip:
            continue
        prod = prod * _gather_rows(Ws[j], st.indices[:, j], method)
    return prod


def _scatter_rows(prod, idx, n_segments: int, method: str = "native"):
    """sum_n prod[n, :] into rows idx[n] of an (n_segments, R) output.

    ``method``: 'native' (jax.ops.segment_sum; 'segment' is a synonym)
    or 'onehot' (matmul). Both are exact in
    f32 up to summation order: the one-hot matmul accumulates in f32
    (ones are exact in any float format)."""
    if method == "onehot":
        onehot = (idx[:, None] == jnp.arange(n_segments,
                                             dtype=idx.dtype)[None, :])
        # HIGHEST precision: a DEFAULT-precision f32 matmul may run in
        # TF32 and round prod — the kernel swap must stay numerically
        # invisible vs segment_sum (f32 summation-order noise only)
        return jax.lax.dot_general(
            onehot.astype(prod.dtype), prod,
            (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32
            if prod.dtype != jnp.float64 else jnp.float64
        ).astype(prod.dtype)
    return jax.ops.segment_sum(prod, idx, num_segments=n_segments)


def mttkrp(st: SparseTensor, Ws: Sequence, mode: int,
           method: str = "native"):
    """Exact sparse MTTKRP: M[i, r] = sum_nnz v * prod_{j != mode} W_j.

    Reference semantics: KhatriRao_contract on a sparse CTF tensor
    (common.cxx:931-997 with V sparse). ``method``: see
    :func:`_scatter_rows`; it selects the gathers too.
    """
    prod = _gathered_kr(st, Ws, (mode,), method)
    return _scatter_rows(prod, st.indices[:, mode], st.shape[mode],
                         method)


def pair_cache(st: SparseTensor, Ws: Sequence, i: int, j: int):
    """PP pair cache T_{ij} (rank-major, (R, s_i, s_j)) from the nonzeros:
    one fused-index segment_sum per pair (Build_mttkrp_map semantics,
    als_CP.cxx:352-409, with V sparse)."""
    prod = _gathered_kr(st, Ws, (i, j))
    fused = st.indices[:, i].astype(jnp.int32) * st.shape[j] \
        + st.indices[:, j].astype(jnp.int32)
    flat = jax.ops.segment_sum(prod, fused,
                               num_segments=st.shape[i] * st.shape[j])
    return jnp.transpose(flat.reshape(st.shape[i], st.shape[j], -1),
                         (2, 0, 1))


def build_pp_caches(st: SparseTensor, Ws: Sequence, method: str = "native"):
    """All PP caches from the sparse tensor: singles M_i (s_i, R) and
    rank-major pairs T_{ij} (R, s_i, s_j) — the same cache layout as
    contract.build_pp_caches, so PP sweeps are shared with the dense
    engine.

    Prefix/suffix-product reuse (the sparse analogue of the reference's
    memoized chain build, als_CP.cxx:352-409): gathered per-mode factor
    rows are combined into prefix_k = v * prod_{j<k} W_j[idx_j] and
    suffix_k = prod_{j>=k} W_j[idx_j] once, then every pair (i, j)
    product is prefix_i * mid(i..j) * suffix_{j+1} with the mid
    accumulated along j — O(N^2) elementwise (nnz, R) multiplies total
    instead of O(N^3) when each pair re-gathers its own chain.
    ``method`` selects the gathers and the single-cache scatters (see
    :func:`_scatter_rows`); pair caches always scatter with segment_sum."""
    order = st.ndim
    R = Ws[0].shape[1]
    rows = [_gather_rows(Ws[j], st.indices[:, j], method)
            for j in range(order)]
    ones = jnp.ones((st.nnz, R), Ws[0].dtype)
    prefix = [st.values[:, None] * ones]          # prefix[k]: v * prod_{j<k}
    for k in range(order):
        prefix.append(prefix[k] * rows[k])
    suffix = [None] * (order + 1)                 # suffix[k]: prod_{j>=k}
    suffix[order] = ones
    for k in reversed(range(order)):
        suffix[k] = suffix[k + 1] * rows[k]

    def scatter_single(prod, i):
        return _scatter_rows(prod, st.indices[:, i], st.shape[i], method)

    def scatter_pair(prod, i, j):
        fused = st.indices[:, i].astype(jnp.int32) * st.shape[j] \
            + st.indices[:, j].astype(jnp.int32)
        flat = jax.ops.segment_sum(prod, fused,
                                   num_segments=st.shape[i] * st.shape[j])
        return jnp.transpose(flat.reshape(st.shape[i], st.shape[j], -1),
                             (2, 0, 1))

    single = {i: scatter_single(prefix[i] * suffix[i + 1], i)
              for i in range(order)}
    pair = {}
    for i in range(order):
        mid = prefix[i]                            # v * prod_{j<i}
        for j in range(i + 1, order):
            pair[(i, j)] = scatter_pair(mid * suffix[j + 1], i, j)
            mid = mid * rows[j]                    # absorb mode j
    return single, pair


# ---------------------------------------------------------------------------
# Sparse Tucker kernels (-issparse 1 -model Tucker)
#
# The reference threads the sparsity flag into the Tucker CTF tensors too
# (test_ALS.cxx:229, 364-396) and relies on CTF's sparse contraction
# engine. JAX equivalent: contract ONE mode of the COO tensor with
# a factor via a fused-index segment_sum — the result is a DENSE tensor
# with that mode reduced to its rank (the same dense intermediate the
# dense engine's own TTMc chain materializes after one step) — then the
# remaining chain runs on the dense engine. The first contracted mode is
# chosen for maximum size reduction (s_m / r_m), so the densified
# intermediate is as small as possible.
# ---------------------------------------------------------------------------


def ttm_dense(st: SparseTensor, W, mode: int, rank_last: bool = False):
    """Sparse tensor-times-matrix: V x_mode W^T -> DENSE tensor with
    ``mode``'s axis reduced to W's rank, all axis positions preserved
    (or, with ``rank_last``, remaining modes ascending + rank axis last —
    the dimension-tree first-level layout, contract.first_contraction).

    One gather + one fused-index segment_sum (static shapes); the output
    is the dense first-level intermediate (als_Tucker.cxx:95-108 step 1 /
    mttkrp_map_init, V sparse).
    """
    order = st.ndim
    r = W.shape[1]
    others = [m for m in range(order) if m != mode]
    fused = jnp.zeros((st.nnz,), jnp.int32)
    for m in others:
        fused = fused * st.shape[m] + st.indices[:, m].astype(jnp.int32)
    vals = st.values[:, None] * _gather_rows(W, st.indices[:, mode])
    n_seg = int(np.prod([st.shape[m] for m in others]))
    flat = _scatter_rows(vals, fused, n_seg)
    out = flat.reshape(tuple(st.shape[m] for m in others) + (r,))
    if rank_last:
        return out
    return jnp.moveaxis(out, -1, mode)


def _best_contract_mode(st: SparseTensor, ranks, keep) -> int:
    """The non-kept mode with the largest size reduction s_m / r_m."""
    cands = [m for m in range(st.ndim) if m not in keep]
    return max(cands, key=lambda m: st.shape[m] / max(ranks[m], 1))


def ttmc(st: SparseTensor, Ws: Sequence, skip_mode: int = -1):
    """Sparse TTMc over all modes except ``skip_mode``: one sparse TTM on
    the best-reducing mode, then the dense chain (contract.ttmc
    semantics, als_Tucker.cxx:76-110 with V sparse)."""
    from pairwise_perturbation_tpu.ops import contract
    order = st.ndim
    ranks = [W.shape[1] for W in Ws]
    keep = () if skip_mode < 0 else (skip_mode,)
    m0 = _best_contract_mode(st, ranks, keep)
    T = ttm_dense(st, Ws[m0], m0)
    for m in range(order):
        if m in keep or m == m0:
            continue
        T = contract.ttmc_contract_mode(T, Ws[m], m)
    return T


def build_ttmc_caches(st: SparseTensor, Ws: Sequence):
    """Tucker PP caches from the sparse tensor — same layouts as
    contract.build_ttmc_caches (kept modes tensor-sized, contracted modes
    rank-sized), so PP sweeps are shared with the dense engine.

    Each cache densifies through ONE memoized sparse TTM (the
    best-reducing mode outside the kept set) and finishes with dense
    contractions; the memo is safe because every cache of one build uses
    the same factor snapshot (Build_ttmc_map, als_Tucker.cxx:426-466).
    """
    from pairwise_perturbation_tpu.ops import contract
    order = st.ndim
    ranks = [W.shape[1] for W in Ws]
    memo = {}

    def first(m0):
        if m0 not in memo:
            memo[m0] = ttm_dense(st, Ws[m0], m0)
        return memo[m0]

    def cache(keep):
        m0 = _best_contract_mode(st, ranks, keep)
        T = first(m0)
        for m in range(order):
            if m in keep or m == m0:
                continue
            T = contract.ttmc_contract_mode(T, Ws[m], m)
        return T

    single = {i: cache((i,)) for i in range(order)}
    pair = {(i, j): cache((i, j))
            for i in range(order) for j in range(i + 1, order)}
    return single, pair


def mode_subspace_sketch(st: SparseTensor, mode: int, k: int, key):
    """Randomized range sketch of the mode-``mode`` unfolding:
    B = unfold(V) Omega with Omega iid uniform — computed sparsely.
    QR of B spans the leading subspace; the sparse-native replacement
    for the dense Gram + eigh HOSVD init (get_factor_matrices,
    als_Tucker.cxx:12-23 / randomized_svd, common.cxx:691-708).

    Omega rows are generated ON THE FLY per nonzero from a counter-based
    PRNG keyed on the other-mode index tuple (fold_in chain): no dense
    (prod-of-other-modes, k) materialization and no fused-index integer
    at all, so arbitrarily large unfoldings neither OOM nor wrap int32
    (two nonzeros sharing a column see the same key, hence the same
    Omega row)."""
    order = st.ndim
    others = [m for m in range(order) if m != mode]
    dtype = st.values.dtype

    def row_omega(idx_row):
        kk = key
        for m in others:
            kk = jax.random.fold_in(kk, idx_row[m])
        return jax.random.uniform(kk, (k,), dtype=dtype,
                                  minval=-1.0, maxval=1.0)

    contrib = st.values[:, None] * jax.vmap(row_omega)(st.indices)
    B = jax.ops.segment_sum(contrib, st.indices[:, mode],
                            num_segments=st.shape[mode])
    return B


def mode_power_iter(st: SparseTensor, mode: int, U):
    """One (A A^T) U power pass of the mode unfolding A, sparsely:
    two segment_sums (A^T U then A (A^T U)). Sharpens the randomized
    sketch's subspace (common.cxx:691-708's QR power iteration, V
    sparse).

    The unfolding columns are COMPACTED to the <= nnz columns that are
    actually populated (host-side np.unique over int64 fused indices):
    the intermediate A^T U is (n_populated, k), never the dense
    (prod-of-other-modes, k), and the fused index cannot wrap int32.
    Host-level only (HOSVD init) — not callable under jit."""
    order = st.ndim
    others = [m for m in range(order) if m != mode]
    idx = np.asarray(st.indices)
    cols = np.zeros(idx.shape[0], dtype=np.int64)
    for m in others:
        cols = cols * np.int64(st.shape[m]) + idx[:, m].astype(np.int64)
    uniq, inv = np.unique(cols, return_inverse=True)
    inv = jnp.asarray(inv.astype(np.int32))
    n_seg = max(int(uniq.size), 1)
    P = jax.ops.segment_sum(st.values[:, None] * U[st.indices[:, mode], :],
                            inv, num_segments=n_seg)          # A^T U
    B = jax.ops.segment_sum(st.values[:, None] * P[inv, :],
                            st.indices[:, mode],
                            num_segments=st.shape[mode])      # A (A^T U)
    return B


def cp_gradnorm(st: SparseTensor, Ws: Sequence, regul=None):
    """Exact CP gradient norm against the sparse tensor."""
    from pairwise_perturbation_tpu.ops import contract
    grads = []
    for i in range(st.ndim):
        M = mttkrp(st, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=regul)
        grads.append(contract.gradsubprob(M, S, Ws[i]))
    return jnp.sqrt(contract.sum_sq(grads))


def cp_residual_norm(V_norm_sq, st: SparseTensor, Ws: Sequence):
    """||V - [[W]]|| via the norm identity with a fresh sparse MTTKRP."""
    from pairwise_perturbation_tpu.ops import contract
    M_last = mttkrp(st, Ws, st.ndim - 1)
    return contract.cp_residual_norm(V_norm_sq, M_last, list(Ws))
