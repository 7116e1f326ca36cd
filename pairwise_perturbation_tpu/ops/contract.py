"""Tensor-contraction primitives for CP / Tucker ALS.

JAX replacements for the CTF string-einsum primitives in the reference's
``common.cxx``:

- :func:`mttkrp`            <-> ``KhatriRao_contract`` (common.cxx:931-997)
- :func:`partial_mttkrp`    <-> the chain contractions inside
                                ``Build_mttkrp_map`` (als_CP.cxx:352-409) and
                                ``mttkrp_map_DT`` (common.cxx:20-133)
- :func:`build_pp_caches`   <-> PP cache construction for all mode pairs and
                                singles (als_CP.cxx:667-695)
- :func:`khatri_rao`        <-> ``KhatriRaoProduct`` (common.cxx:889-920)
- :func:`gram` / :func:`hadamard_gram` <-> the ``S`` assembly
                                (als_CP.cxx:573-576, cp_als_optimizer.cxx:update_S)
- :func:`build_dense`       <-> ``build_V`` (common.cxx:135-197)
- :func:`cp_gradient`       <-> ``gradient_CP`` (common.cxx:1009-1052)
- :func:`cp_residual_norm`  <-> the diffV diagnostic (als_CP.cxx:474-479) via
                                the norm identity instead of full
                                reconstruction (no O(s^N) intermediate).
- :func:`ttmc` / :func:`ttmc_contract_mode` <-> ``TTMc`` (als_Tucker.cxx:76-110)
- :func:`build_ttmc_caches` <-> ``Build_ttmc_map`` (als_Tucker.cxx:426-466)
- :func:`mode_gram`         <-> ``unroll_tensor_contraction`` (common.cxx:205-223)
- :func:`normalize_factors` <-> ``Normalize`` (common.cxx:644-689)

All functions are pure and jit-friendly: mode indices are static Python ints,
einsum specs are generated at trace time, and ``optimize=True`` lets
opt_einsum pick the pairwise chain (which is exactly the reference's
one-matrix-at-a-time scheme, but ordered for minimal FLOPs). Large
contractions therefore lower to GEMMs that XLA hands to cuBLAS or fuses.
"""

from __future__ import annotations

import functools as _functools
import string
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import config

# Mode axes use lowercase letters; rank axes use uppercase (jnp.einsum
# accepts both). Supports tensors up to order 26.
_MODES = string.ascii_lowercase
_RANK = "Z"
_RANK2 = "Y"


def _prec(precision):
    return config.default_precision() if precision is None else precision


def _einsum(spec, *ops, precision=None):
    """einsum with mixed-precision handling.

    When any operand is bfloat16 (the mixed-precision mode stores V in
    bf16; factors stay f32), all operands are cast to bf16 so the product
    runs as bf16 x bf16 with f32 accumulation — half the memory traffic
    of f32. Type promotion would otherwise upcast the bf16 side and lose
    that advantage.
    Intermediates and outputs are f32, so only the first contraction of a
    chain (the one touching V) runs in bf16.
    """
    if any(o.dtype == jnp.bfloat16 for o in ops):
        if jax.default_backend() == "cpu":
            # CPU lacks a BF16xBF16=F32 dot kernel. bf16 products are
            # exact in f32 (8-bit mantissas), so rounding the operands to
            # bf16 and multiplying in f32 is numerically equivalent to a
            # native bf16 product with f32 accumulation.
            ops = [o.astype(jnp.bfloat16).astype(jnp.float32) for o in ops]
            return jnp.einsum(spec, *ops, optimize=True,
                              precision=jax.lax.Precision.DEFAULT)
        ops = [o.astype(jnp.bfloat16) for o in ops]
        return jnp.einsum(spec, *ops, optimize=True,
                          precision=jax.lax.Precision.DEFAULT,
                          preferred_element_type=jnp.float32)
    return jnp.einsum(spec, *ops, optimize=True, precision=_prec(precision))


def norm_sq(V):
    """||V||^2 with f32 (or wider) accumulation regardless of V's dtype.

    No ravel: reshaping a mesh-sharded V to 1D makes GSPMD all-gather
    the full tensor onto every device before the reduction (observed in
    the fused machine's HLO); an axis-wise sum reduces locally with one
    cross-device all-reduce instead."""
    acc = jnp.float32 if V.dtype == jnp.bfloat16 else V.dtype
    Va = V.astype(acc)
    return jnp.sum(Va * Va)


# ---------------------------------------------------------------------------
# CP primitives
# ---------------------------------------------------------------------------


def spans_devices(V) -> bool:
    """Whether V is laid out over a mesh of several devices: its abstract
    value names such a mesh (a GSPMD-sharded jit argument, or a block
    inside shard_map). Known at trace time from V itself, so one call
    runs the same code whatever number of devices the process sees."""
    mesh = jax.typeof(V).sharding.mesh
    return any(n > 1 for n in mesh.shape.values())


def mttkrp3_kernel_applies(V) -> bool:
    """Whether :func:`mttkrp` runs the Triton-route Pallas kernel
    (ops/kernels/mttkrp3_triton.py): order-3 f32 V on an NVIDIA GPU that
    is not laid out over several devices. On an H100 it reads V at 81-92%
    of the measured copy bandwidth at 512^3 where XLA's chain reaches
    28-69%, and cuts the 200^3 CP-ALS sweep's device time by 26%
    (PERF.md). A pallas_call cannot be partitioned (XLA would gather a
    sharded V onto every device), so a V on a mesh takes the XLA chain."""
    return (V.ndim == 3 and V.dtype == jnp.float32
            and jax.default_backend() == "gpu" and not spans_devices(V))


def mttkrp(V, factors: Sequence, mode: int, precision=None):
    """Exact MTTKRP for ``mode``: M[i_mode, r] = sum V * prod_{j != mode} W_j.

    Reference: ``KhatriRao_contract`` — M["dk"] = V["abcd"] W1["ak"] W2["bk"]
    W3["ck"] (common.cxx:929). See :func:`mttkrp3_kernel_applies` for the
    order-3 kernel.
    """
    if mttkrp3_kernel_applies(V):
        from pairwise_perturbation_tpu.ops.kernels import mttkrp3_triton
        return mttkrp3_triton.mttkrp3(V, list(factors), mode)
    return mttkrp_xla(V, factors, mode, precision)


def mttkrp_xla(V, factors: Sequence, mode: int, precision=None):
    """:func:`mttkrp` as one einsum that XLA compiles (every order and
    dtype; the baseline the order-3 kernel is measured against)."""
    order = V.ndim
    il = _MODES[:order]
    terms, ops = [il], [V]
    for j in range(order):
        if j == mode:
            continue
        terms.append(il[j] + _RANK)
        ops.append(factors[j])
    spec = ",".join(terms) + "->" + il[mode] + _RANK
    return _einsum(spec, *ops, precision=precision)


def contract_mode_kr(T, rem_modes: Tuple[int, ...], has_rank: bool, factor,
                     mode: int, precision=None):
    """Contract one mode of a partial-MTTKRP intermediate with a factor.

    ``T`` has axes ``rem_modes`` (original mode ids, ascending) plus a
    trailing rank axis when ``has_rank``. Contracting mode ``m`` with
    W_m[s_m, R] removes that axis, Khatri-Rao-style (diagonal in the rank
    axis once it exists). This is the single step of the reference's
    chain contraction V["acd*"] * W["d*"] (als_CP.cxx:383-384).
    """
    pos = rem_modes.index(mode)
    k = len(rem_modes)
    letters = _MODES[:k]
    t_spec = letters + (_RANK if has_rank else "")
    f_spec = letters[pos] + _RANK
    out_spec = letters[:pos] + letters[pos + 1:] + _RANK
    out = _einsum(f"{t_spec},{f_spec}->{out_spec}", T, factor,
                  precision=precision)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def fused_partial_mttkrp(V, factors: Sequence,
                         contract_modes: Sequence[int], precision=None):
    """Partial MTTKRP as ONE einsum (V with all listed factors, Khatri-Rao
    in the rank axis). Within a jit, XLA already fuses single-consumer
    stepwise intermediates, so the gain over :func:`partial_mttkrp` is the
    better einsum/GEMM path only (~8% on the coil-100 DT sweep). Use for
    single-consumer chains; :func:`partial_mttkrp` materializes per step
    for prefix reuse. Returns (tensor, remaining_modes).

    Mixed precision: for bf16-stored V, only the first contraction (the
    one touching V) may run in bf16 — a single einsum would round every
    later-level factor too (see :func:`_einsum`) — so the first step is
    split out and the tail factors contract in one f32 einsum.
    """
    order = V.ndim
    il = _MODES[:order]
    cset = set(contract_modes)
    rem = tuple(m for m in range(order) if m not in cset)
    if V.dtype == jnp.bfloat16 and len(contract_modes) > 1:
        m0 = contract_modes[0]
        T, trem = contract_mode_kr(V, tuple(range(order)), False,
                                   factors[m0], m0, precision=precision)
        k = len(trem)
        letters = _MODES[:k]
        terms, ops = [letters + _RANK], [T]
        for m in contract_modes[1:]:
            terms.append(letters[trem.index(m)] + _RANK)
            ops.append(factors[m])
        out_spec = "".join(letters[trem.index(m)] for m in rem) + _RANK
        spec = ",".join(terms) + "->" + out_spec
        return _einsum(spec, *ops, precision=precision), rem
    terms, ops = [il], [V]
    for m in contract_modes:
        terms.append(il[m] + _RANK)
        ops.append(factors[m])
    spec = ",".join(terms) + "->" + "".join(il[m] for m in rem) + _RANK
    return _einsum(spec, *ops, precision=precision), rem


def partial_mttkrp(V, factors: Sequence, contract_modes: Sequence[int],
                   precision=None):
    """Chain-contract ``V`` with the factors of ``contract_modes`` (in order).

    Returns a tensor whose axes are the remaining modes (ascending original
    order) followed by the rank axis. With all-but-one mode contracted this
    is the exact MTTKRP; with all-but-two it is a PP pair cache
    T_{ij}[s_i, s_j, R].
    """
    order = V.ndim
    T, rem, has_rank = V, tuple(range(order)), False
    for m in contract_modes:
        T, rem = contract_mode_kr(T, rem, has_rank, factors[m], m,
                                  precision=precision)
        has_rank = True
    return T


def contraction_priority(shape: Sequence[int]) -> Tuple[int, ...]:
    """Global mode-contraction order: largest modes first (ties by index).

    The reference chains in ascending mode order (als_CP.cxx:678-694),
    which on e.g. coil-100 (3 x 128 x 128 x 7200) materializes an
    intermediate 2400x the tensor-free size by contracting the size-3 mode
    first. Contracting the largest mode first keeps every intermediate
    small — device memory and its bandwidth are the scarce resources —
    while prefix memoization still shares work (all chains follow one
    global order).

    Delegates to the native planner (native/planner.cpp
    plan_chain_priority, greedy min-next-intermediate) when the .so is
    available; the pure-Python fallback implements the same rule. Called
    at trace time only; memoized per shape.
    """
    return _priority_cached(tuple(int(s) for s in shape))


@_functools.lru_cache(maxsize=None)
def _priority_cached(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    from pairwise_perturbation_tpu import native
    pr, _peak = native.plan_chain_priority(shape, 1)
    return tuple(pr)


def order_by_priority(modes, priority: Sequence[int]) -> Tuple[int, ...]:
    rank_of = {m: i for i, m in enumerate(priority)}
    return tuple(sorted(modes, key=lambda m: rank_of[m]))


def prepare_layouts(V, modes: Sequence[int], precision=None):
    """Materialize mode-minor permuted copies of V for the given modes.

    Contracting a non-minor axis can make XLA transpose V (a full extra
    read+write of device memory) on *every* call. A one-time permuted
    copy V_perm[m] = moveaxis(V, m, -1) turns every first-level
    contraction of mode m into a minor-dim GEMM. Memory cost: |V| per
    layout (opt-in via ``-layouts``).
    """
    out = {}
    for m in modes:
        if m == V.ndim - 1:
            continue  # already minor
        out[m] = jnp.moveaxis(V, m, -1).copy()
    return out


def first_contraction(V, layouts, factor, mode: int, precision=None):
    """V x_m W_m (Khatri-Rao first level). Output axes: remaining modes
    ascending + rank (same convention as :func:`contract_mode_kr`).
    A mode-minor layout of V is used when available, else a plain einsum.
    """
    order = V.ndim
    if layouts and mode in layouts:
        Vp = layouts[mode]
        k = Vp.ndim
        letters = _MODES[:k]
        spec = f"{letters},{letters[k-1]}{_RANK}->{letters[:k-1]}{_RANK}"
        out = _einsum(spec, Vp, factor, precision=precision)
        rem = tuple(m for m in range(order) if m != mode)
        return out, rem
    return contract_mode_kr(V, tuple(range(order)), False, factor, mode,
                            precision=precision)


def chain_root_modes_pp(shape) -> Tuple[int, ...]:
    """Modes contracted first by some PP cache chain (candidates for
    :func:`prepare_layouts`)."""
    order = len(shape)
    pr = contraction_priority(shape)
    roots = set()
    for i in range(order):
        for j in range(i + 1, order):
            key = order_by_priority(
                (m for m in range(order) if m not in (i, j)), pr)
            roots.add(key[0])
        key = order_by_priority((m for m in range(order) if m != i), pr)
        roots.add(key[0])
    return tuple(sorted(roots))


def chain_root_modes_dt(shape, root_split: int = None) -> Tuple[int, ...]:
    """Modes contracted first when building the binary tree's top-level
    nodes (one per child of the root). ``root_split`` as in
    ops.dimtree.binary_parent_map (None = midpoint)."""
    order = len(shape)
    pr = contraction_priority(shape)
    mid = (order - 1) // 2 if root_split is None else root_split
    roots = set()
    for lo, hi in ((0, mid), (mid + 1, order - 1)):
        comp = [m for m in range(order) if not lo <= m <= hi]
        if comp:
            roots.add(order_by_priority(comp, pr)[0])
    return tuple(sorted(roots))


def _first_contraction_rm(V, layouts, factor, mode: int, precision=None):
    """First-level contraction producing a RANK-MAJOR intermediate
    (R, remaining modes ascending). The PP cache chains keep rank
    major-most throughout (see :func:`build_pp_caches`)."""
    order = V.ndim
    rem = tuple(m for m in range(order) if m != mode)
    if layouts and mode in layouts:
        Vp = layouts[mode]  # axes: rem ascending + mode minor
        k = Vp.ndim
        letters = _MODES[:k]
        spec = f"{letters},{letters[k-1]}{_RANK}->{_RANK}{letters[:k-1]}"
        return _einsum(spec, Vp, factor, precision=precision), rem
    letters = _MODES[:order]
    out = letters[:mode] + letters[mode + 1:]
    spec = f"{letters},{letters[mode]}{_RANK}->{_RANK}{out}"
    return _einsum(spec, V, factor, precision=precision), rem


def _contract_mode_kr_rm(T, rem_modes: Tuple[int, ...], factor, mode: int,
                         precision=None):
    """One Khatri-Rao chain step on a rank-major intermediate
    (R, rem_modes...) -> (R, rem_modes without mode)."""
    pos = rem_modes.index(mode)
    k = len(rem_modes)
    letters = _MODES[:k]
    t_spec = _RANK + letters
    f_spec = letters[pos] + _RANK
    out_spec = _RANK + letters[:pos] + letters[pos + 1:]
    out = _einsum(f"{t_spec},{f_spec}->{out_spec}", T, factor,
                  precision=precision)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def build_pp_caches(V, factors: Sequence, precision=None, layouts=None):
    """Build all PP caches: pair tensors T_{ij}[s_i, s_j, R] for i<j and
    single matrices M_i[s_i, R].

    Mirrors the reference's ``Build_mttkrp_map`` calls over all (ii, jj)
    pairs then all singles (als_CP.cxx:676-694), including the memoized
    prefix reuse (als_CP.cxx:385-389): cache keys are the *contracted* mode
    tuples; a chain sharing a prefix reuses the prefix intermediate.
    Chains follow :func:`contraction_priority` (largest modes first) so
    intermediates stay small. Intended to be called inside jit so XLA
    fuses the whole build. ``layouts`` (from :func:`prepare_layouts`)
    accelerates the first contraction of each chain.
    """
    order = V.ndim
    priority = contraction_priority(V.shape)
    # The whole chain runs RANK-MAJOR (R leading): chain intermediates
    # have multiple consumers, so XLA materializes them, and rank-major
    # is the natural batch layout for the downstream correction dots
    # (pair caches are consumed as (R, s_i, s_j)).
    memo: Dict[Tuple[int, ...], Tuple] = {}

    def get(key: Tuple[int, ...]):
        if key not in memo:
            if len(key) == 1:
                m = key[0]
                T2, rem2 = _first_contraction_rm(
                    V, layouts, factors[m], m, precision=precision)
            else:
                T, rem = get(key[:-1])
                T2, rem2 = _contract_mode_kr_rm(T, rem, factors[key[-1]],
                                                key[-1], precision=precision)
            memo[key] = (T2, rem2)
        return memo[key]

    R = factors[0].shape[1]
    pair = {}
    for i in range(order):
        for j in range(i + 1, order):
            key = order_by_priority(
                (m for m in range(order) if m not in (i, j)), priority)
            if not key:  # order-2 tensor: the pair cache IS V (rank-bcast)
                pair[(i, j)] = jnp.broadcast_to(
                    V[None].astype(factors[0].dtype), (R,) + V.shape)
                continue
            pair[(i, j)] = get(key)[0]          # already (R, s_i, s_j)
    single = {}
    for i in range(order):
        key = order_by_priority(
            (m for m in range(order) if m != i), priority)
        single[i] = jnp.transpose(get(key)[0])  # (s_i, R) for the solves
    return single, pair


def pp_correct_mttkrp(single_i, pair, dWs: Sequence, i: int, precision=None):
    """First-order PP-corrected MTTKRP for mode ``i``:

    M~_i = M_i + sum_{j<i} T_{ji} x_j dW_j + sum_{j>i} T_{ij} x_j dW_j

    Reference: als_CP.cxx:778-794. ``pair[(a, b)]`` is RANK-MAJOR with
    axes (R, s_a, s_b) — see :func:`build_pp_caches`.
    """
    order = len(dWs)
    M = single_i
    for j in range(order):
        if j == i:
            continue
        if j < i:
            M = M + _einsum("Zab,aZ->bZ", pair[(j, i)], dWs[j],
                            precision=precision)
        else:
            M = M + _einsum("Zab,bZ->aZ", pair[(i, j)], dWs[j],
                            precision=precision)
    return M


def khatri_rao(factors: Sequence, precision=None):
    """Explicit Khatri-Rao product tensor H[s_1, ..., s_k, R].

    Reference: ``KhatriRaoProduct`` (common.cxx:889-920).
    """
    k = len(factors)
    terms = [(_MODES[j] + _RANK) for j in range(k)]
    spec = ",".join(terms) + "->" + _MODES[:k] + _RANK
    return _einsum(spec, *factors, precision=precision)


def gram(W, precision=None):
    """W^T W (R x R)."""
    return _einsum("iZ,iY->ZY".replace("Z", "a").replace("Y", "b"), W, W,
                   precision=precision)


def hadamard_gram(factors: Sequence, skip_mode: int = -1, regul=None,
                  precision=None):
    """S = Hadamard product of W_j^T W_j over j != skip_mode (+ lambda I).

    Reference: S["ij"] = prod (W[idx]["ki"] W[idx]["kj"]) (+ regul)
    (als_CP.cxx:573-578, cp_als_optimizer.cxx update_S).
    """
    S = None
    for j, W in enumerate(factors):
        if j == skip_mode:
            continue
        G = gram(W, precision=precision)
        S = G if S is None else S * G
    if regul is not None:
        R = S.shape[0]
        S = S + regul * jnp.eye(R, dtype=S.dtype)
    return S


def build_dense(factors: Sequence, precision=None):
    """Reconstruct the dense rank-R CP tensor from factors.

    Reference: ``build_V`` (common.cxx:135-197). O(s^N) output — use only
    for small tensors / tests; solvers use :func:`cp_residual_norm`.
    """
    k = len(factors)
    terms = [(_MODES[j] + _RANK) for j in range(k)]
    spec = ",".join(terms) + "->" + _MODES[:k]
    return _einsum(spec, *factors, precision=precision)


def cp_gradient(V, factors: Sequence, regul=None, precision=None):
    """Full CP gradient for all modes: grad_i = -M_i + W_i S_i.

    Reference: ``gradient_CP`` (common.cxx:1009-1052).
    """
    grads = []
    for i in range(len(factors)):
        M = mttkrp(V, factors, i, precision=precision)
        S = hadamard_gram(factors, skip_mode=i, regul=regul,
                          precision=precision)
        grads.append(gradsubprob(M, S, factors[i], precision=precision))
    return grads


def gradsubprob(M, S, W, precision=None):
    """grad = -M + W S (common.cxx:1002-1004)."""
    return -M + jnp.matmul(W, S, precision=_prec(precision))


def sum_sq(xs):
    """sum_k ||x_k||_F^2 over a list of arrays, at the configured
    precision (``jnp.vdot`` is a dot product, which a GPU may run in TF32
    at DEFAULT precision)."""
    return sum(jnp.vdot(x, x, precision=_prec(None)) for x in xs)


def cp_gradnorm(V, factors: Sequence, regul=None, precision=None):
    """EXACT CP gradient norm sqrt(sum_i ||-M_i + W_i S_i||^2) at the
    current iterate (fresh MTTKRP per mode).

    Diagnostics-only: the per-sweep gradnorm logged by the reference
    (als_CP.cxx:174-181) mixes within-sweep gradients whose scale differs
    between the DT and PP phases (exact vs perturbative M); recomputing at
    the logged iterate makes the CSV's convergence column mean one thing
    across phases. Cost: N exact MTTKRPs, paid only on logged rows and
    excluded from dtime like all diagnostics.
    """
    grads = cp_gradient(V, factors, regul=regul, precision=precision)
    return jnp.sqrt(sum_sq(grads))


def cp_residual_norm(V_norm_sq, M_last, factors: Sequence, precision=None):
    """|| V - [[W_1 .. W_N]] ||_F via the norm identity:

    ||V - Vhat||^2 = ||V||^2 - 2 <M_N, W_N> + 1^T (hadamard of all Grams) 1

    where M_N is the *exact* MTTKRP of the last mode. Replaces the
    reference's full ``build_V`` reconstruction diagnostic
    (als_CP.cxx:474-479) at the cost of one MTTKRP and no O(s^N) temp.
    """
    last = len(factors) - 1
    inner = jnp.sum(M_last * factors[last])
    S_all = hadamard_gram(factors, skip_mode=-1, precision=precision)
    vhat_sq = jnp.sum(S_all)
    return jnp.sqrt(jnp.maximum(V_norm_sq - 2.0 * inner + vhat_sq, 0.0))


def cp_residual_exact(V, factors: Sequence, precision=None):
    """Exact reconstruction residual (test oracle)."""
    Vhat = build_dense(factors, precision=precision)
    return jnp.linalg.norm((V - Vhat).ravel())


def normalize_factors(factors: Sequence, precision=None):
    """Rebalance all factor Frobenius norms to their geometric mean.

    Reference: ``Normalize`` (common.cxx:680-689).
    """
    norms = [jnp.linalg.norm(W.ravel()) for W in factors]
    target = jnp.prod(jnp.stack(norms)) ** (1.0 / len(factors))
    return [W * (target / n) for W, n in zip(factors, norms)]


# ---------------------------------------------------------------------------
# Tucker primitives
# ---------------------------------------------------------------------------


def ttmc_contract_mode(T, factor, axis: int, transpose: bool = False,
                       precision=None):
    """Contract one mode of ``T`` with a factor, keeping axis position.

    ``factor`` is (s, r); the axis of length s becomes length r (or the
    reverse when ``transpose``). Single step of ``TTMc``
    (als_Tucker.cxx:95-108).
    """
    k = T.ndim
    letters = _MODES[:k]
    t_spec = letters
    f_spec = (letters[axis] + _RANK) if not transpose else (_RANK + letters[axis])
    out_spec = letters[:axis] + _RANK + letters[axis + 1:]
    return _einsum(f"{t_spec},{f_spec}->{out_spec}", T, factor,
                   precision=precision)


def ttmc(V, factors: Sequence, skip_mode: int = -1, transpose: bool = False,
         precision=None):
    """Tensor-times-matrix chain over all modes except ``skip_mode``.

    ``skip_mode=-1`` contracts every mode (the core update). With
    ``transpose=True`` the factors map rank -> size (reconstruction,
    als_Tucker.cxx:303 uses W^T the same way).

    Implemented as one einsum with distinct output letters per contracted
    mode so opt_einsum orders the chain optimally.
    """
    order = V.ndim
    in_letters = _MODES[:order]
    out_letters = list(in_letters)
    terms, ops = [in_letters], [V]
    rank_letters = string.ascii_uppercase
    k = 0
    for j in range(order):
        if j == skip_mode:
            continue
        rl = rank_letters[k]
        k += 1
        terms.append((in_letters[j] + rl) if not transpose else (rl + in_letters[j]))
        ops.append(factors[j])
        out_letters[j] = rl
    spec = ",".join(terms) + "->" + "".join(out_letters)
    return _einsum(spec, *ops, precision=precision)


def build_ttmc_caches(V, factors: Sequence, precision=None):
    """PP caches for Tucker: pair tensors (modes i, j uncontracted) and
    single tensors (mode i uncontracted), with memoized prefix reuse.

    Mirrors ``Build_ttmc_map`` over all pairs then singles
    (als_Tucker.cxx:744-760). Axis positions are preserved: contracted
    modes have rank-sized axes. Chains follow the largest-mode-first
    global priority so intermediates shrink fastest.
    """
    order = V.ndim
    priority = contraction_priority(V.shape)
    memo: Dict[Tuple[int, ...], object] = {(): V}

    def get(key: Tuple[int, ...]):
        if key not in memo:
            T = get(key[:-1])
            memo[key] = ttmc_contract_mode(T, factors[key[-1]], key[-1],
                                           precision=precision)
        return memo[key]

    pair = {}
    for i in range(order):
        for j in range(i + 1, order):
            key = order_by_priority(
                (m for m in range(order) if m not in (i, j)), priority)
            pair[(i, j)] = get(key)
    single = {}
    for i in range(order):
        key = order_by_priority(
            (m for m in range(order) if m != i), priority)
        single[i] = get(key)
    return single, pair


def pp_correct_ttmc(single_i, pair, dWs: Sequence, i: int, precision=None):
    """First-order PP-corrected TTMc for mode ``i``:

    Y~_i = Y_i + sum_{j != i} cache_{ij} x_j dW_j

    Reference: als_Tucker.cxx:835-859.
    """
    order = len(dWs)
    Y = single_i
    for j in range(order):
        if j == i:
            continue
        cache = pair[(min(i, j), max(i, j))]
        Y = Y + ttmc_contract_mode(cache, dWs[j], j, precision=precision)
    return Y


def mode_gram(T, axis: int, precision=None):
    """Gram matrix of the mode-``axis`` unfolding: T_(i) T_(i)^T.

    Reference: ``unroll_tensor_contraction`` (common.cxx:205-223).
    """
    k = T.ndim
    letters = _MODES[:k]
    a_spec = letters[:axis] + _RANK + letters[axis + 1:]
    b_spec = letters[:axis] + _RANK2 + letters[axis + 1:]
    return _einsum(f"{a_spec},{b_spec}->{_RANK}{_RANK2}", T, T,
                   precision=precision)


def tucker_residual_norm(V_norm_sq, core_exact, core, precision=None):
    """|| V - core x_i W_i ||_F with orthonormal W via the norm identity:

    ||V - Vhat||^2 = ||V||^2 - 2 <TTMc(V, W), core> + ||core||^2.

    Replaces the reconstruction check at als_Tucker.cxx:296-311.
    ``core_exact`` = TTMc(V, W, -1) with the current factors.
    """
    inner = jnp.sum(core_exact * core)
    core_sq = jnp.sum(core * core)
    return jnp.sqrt(jnp.maximum(V_norm_sq - 2.0 * inner + core_sq, 0.0))


def fold_unfold(X, shape):
    """Reshape preserving global (row-major) element order.

    Reference: ``fold_unfold`` (common.cxx:870-880).
    """
    return X.reshape(shape)
