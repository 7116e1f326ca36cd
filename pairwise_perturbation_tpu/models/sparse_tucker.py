"""Sparse Tucker-ALS solvers (COO tensors): HOOI and pairwise
perturbation.

Reference: the ``-issparse`` path of the legacy Tucker driver — the
sparsity flag is threaded into the Tucker CTF tensor constructors
(test_ALS.cxx:229, 364-396) and the same alsTucker / alsTucker_PP
algorithms run on them. Scope here:

- exact sweeps contract ONE mode of the COO tensor sparsely (fused-index
  segment_sum, ops/sparse.ttm_dense) and finish the TTMc chain densely —
  the dense intermediate after one contraction is exactly what the dense
  engine materializes anyway, and the first mode is chosen for maximum
  size reduction;
- HOSVD init uses a randomized range sketch computed sparsely
  (ops/sparse.mode_subspace_sketch + power iteration) instead of the
  dense Gram + eigh — the sparse-native analogue of the reference's own
  randomized_svd (common.cxx:691-708); HOOI self-corrects from there;
- PP cache builds densify through memoized sparse TTMs
  (ops/sparse.build_ttmc_caches); PP sweeps are IDENTICAL to the dense
  engine's (models/tucker.tucker_pp_sweep) because caches and factors
  are dense either way.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pairwise_perturbation_tpu.models import cp as cpm
from pairwise_perturbation_tpu.models import tucker as tkm
from pairwise_perturbation_tpu.ops import contract, solve
from pairwise_perturbation_tpu.ops import sparse as sp
from pairwise_perturbation_tpu.utils import tracing
from pairwise_perturbation_tpu.utils.metrics import PlotFile, SweepClock


def _sp_ttmc(st, Ws, skip_mode, mesh=None):
    """Sparse-first TTMc, optionally over an nnz-sharded mesh (shard_map
    partials + one psum, parallel/mesh.sharded_sparse_ttmc)."""
    if mesh is not None:
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        return pmesh.sharded_sparse_ttmc(st, list(Ws), skip_mode, mesh)
    return sp.ttmc(st, list(Ws), skip_mode=skip_mode)


@partial(jax.jit, static_argnames=("ranks", "use_sign", "mesh"))
def sparse_hooi_sweep(st, Ws, sign_refs, *, ranks: Tuple[int, ...],
                      use_sign: bool, mesh=None):
    """One HOOI sweep with sparse-first TTMc per mode (alsTucker body,
    als_Tucker.cxx:148-163, V sparse). Returns (Ws_new, core). With
    ``mesh`` (static 1D jax Mesh) every TTMc runs as nnz-shard partials
    + psum; the extraction eighs are replicated on-chip (SURVEY §2.6)."""
    order = st.ndim
    Ws = list(Ws)
    Y_end = None
    for i in range(order):
        Y = _sp_ttmc(st, Ws, i, mesh)
        if i == order - 1:
            Y_end = Y
        ref = sign_refs[i] if use_sign else None
        Ws[i] = tkm._factor_from_Y(Y, i, ranks[i], ref, warm=sign_refs[i],
                                   subspace_iters=0)
    core = contract.ttmc_contract_mode(Y_end, Ws[order - 1], order - 1)
    return Ws, core


@partial(jax.jit, static_argnames=("mesh",))
def sparse_tucker_build_caches(st, Ws, *, mesh=None):
    if mesh is not None:
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        return pmesh.sharded_sparse_ttmc_caches(st, list(Ws), mesh)
    return sp.build_ttmc_caches(st, list(Ws))


@partial(jax.jit, static_argnames=("mesh",))
def sparse_tucker_diagnostics(V_norm_sq, st, Ws, core_prev_norm, *,
                              mesh=None):
    """(core norm, diffnorm, diffV) with an exact sparse TTMc core."""
    core = _sp_ttmc(st, Ws, -1, mesh)
    cn = jnp.linalg.norm(core.ravel())
    diffnorm = jnp.abs(cn - core_prev_norm)
    diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
    return cn, diffnorm, diffV


def hosvd_sparse(st, ranks, key=None, oversample: int = 8,
                 power_iters: int = 1):
    """Randomized sparse HOSVD: per-mode range sketch (+ power passes) of
    the unfolding, leading ``r`` left singular vectors from the small
    sketch SVD. Returns (core, Ws). Init-accuracy replacement for the
    exact hosvd (als_Tucker.cxx:25-70) — HOOI self-corrects."""
    if key is None:
        key = jax.random.PRNGKey(0)
    order = st.ndim
    Ws: List = []
    keys = jax.random.split(key, order)
    for i in range(order):
        k = min(int(ranks[i]) + oversample, st.shape[i])
        B = sp.mode_subspace_sketch(st, i, k, keys[i])
        for _ in range(power_iters):
            Q, _ = jnp.linalg.qr(B)
            B = sp.mode_power_iter(st, i, Q)
        U, _, _ = jnp.linalg.svd(B, full_matrices=False)
        Ws.append(solve.fix_sign_columns(U[:, :int(ranks[i])]))
    core = sp.ttmc(st, Ws, skip_mode=-1)
    return core, Ws


def _diag_and_log(V_norm_sq, st, Ws, cn_prev, clock, plot, it, tol,
                  pp_flag, history, mesh=None):
    jax.block_until_ready(Ws)
    with clock.exclude():
        cn, dn, diffV = tracing.timed(
            "sparse_tucker.diagnostics", sparse_tucker_diagnostics,
            V_norm_sq, st, Ws, cn_prev, mesh=mesh)
        cn, dn, diffV = float(cn), float(dn), float(diffV)
    dtime = clock.dtime()
    if plot is not None:
        plot.row(st.shape[0], it, dn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, diffnorm=dn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return cn, dn, diffV, dtime


def als_tucker_sparse(st, ranks, cfg: tkm.TuckerConfig,
                      plot: Optional[PlotFile] = None,
                      Ws: Optional[List] = None,
                      clock: Optional[SweepClock] = None,
                      mesh=None, init_st=None) -> tkm.TuckerResult:
    """Plain sparse HOOI (alsTucker, als_Tucker.cxx:120-176, V sparse).
    ``mesh``: 1D nnz-sharded mesh — every TTMc / diagnostic runs as
    shard_map partials + psum. ``init_st``: unsharded COO for the HOSVD
    init (host-level np.unique compaction; setup, not sweep time)."""
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
    with clock.exclude():
        if Ws is None:
            _core, Ws = tracing.timed("sparse_tucker.hosvd", hosvd_sparse,
                                      init_st if init_st is not None
                                      else st, ranks)
        else:
            Ws = [jnp.asarray(W) for W in Ws]
        cpm.warm_compile(sparse_hooi_sweep, st, Ws, list(Ws), ranks=ranks,
                         use_sign=True, mesh=mesh)
    history: list = []
    cn_prev = jnp.asarray(0.0, Ws[0].dtype)
    dn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    core = None
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            cn, dn, diffV, dtime = _diag_and_log(
                V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol, 0,
                history, mesh)
            cn_prev = jnp.asarray(cn, Ws[0].dtype)
            if dn < cfg.tol and it > 0:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws, core = tracing.timed("sparse_tucker.sweep", sparse_hooi_sweep,
                                 st, Ws, list(Ws), ranks=ranks,
                                 use_sign=True, mesh=mesh)
        it += 1
    if core is None:
        core = _sp_ttmc(st, list(Ws), -1, mesh)
    return tkm.TuckerResult(Ws, core, dn, diffV, it, converged, history)


def als_tucker_pp_sparse(st, ranks, cfg: tkm.TuckerConfig,
                         plot: Optional[PlotFile] = None,
                         Ws: Optional[List] = None,
                         clock: Optional[SweepClock] = None,
                         mesh=None, init_st=None) -> tkm.TuckerResult:
    """Sparse Tucker PP: exact phase = sparse HOOI sweeps with dW
    tracking and sign-fixing (alsTucker_DT_sub role); PP phase = the
    dense engine's tucker_pp_sweep on sparse-built caches, with the
    restart tolerance, 15-sweep cap and tol_init decay
    (alsTucker_PP, als_Tucker.cxx:906-962, V sparse)."""
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
    with clock.exclude():
        if Ws is None:
            _core, Ws = tracing.timed("sparse_tucker.hosvd", hosvd_sparse,
                                      init_st if init_st is not None
                                      else st, ranks)
        else:
            Ws = [jnp.asarray(W) for W in Ws]
        cpm.warm_compile(sparse_hooi_sweep, st, Ws, list(Ws), ranks=ranks,
                         use_sign=True, mesh=mesh)
        cpm.warm_compile(sparse_tucker_build_caches, st, Ws, mesh=mesh)
    history: list = []
    cn_prev = jnp.asarray(0.0, Ws[0].dtype)
    dn, diffV = float("inf"), float("inf")
    tol_init = cfg.pp_res_tol
    it = 0
    core = None
    while it <= cfg.maxiter and not (dn < cfg.tol and it > 0):
        # ---- exact phase (alsTucker_DT_sub role) ----
        W_prev = [jnp.zeros_like(W) for W in Ws]
        quiet = False
        while it <= cfg.maxiter:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                cn, dn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol,
                    0, history, mesh)
                cn_prev = jnp.asarray(cn, Ws[0].dtype)
                if (dn < cfg.tol and it > 0) or dtime > cfg.timelimit:
                    if core is None:
                        core = _sp_ttmc(st, list(Ws), -1, mesh)
                    return tkm.TuckerResult(Ws, core, dn, diffV, it,
                                            dn < cfg.tol, history)
            Ws, core = tracing.timed("sparse_tucker.sweep",
                                     sparse_hooi_sweep, st, Ws, list(Ws),
                                     ranks=ranks, use_sign=True,
                                     mesh=mesh)
            dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
            W_prev = [W for W in Ws]
            ratios = cpm._host_pull(cpm.factor_norm_ratios(Ws, dWs))
            it += 1
            if int(np.sum(np.abs(ratios) < tol_init)) == len(Ws):
                quiet = True
                break
        if not quiet or it > cfg.maxiter:
            break
        # ---- PP phase (alsTucker_PP_sub) ----
        single, pair = tracing.timed("sparse_tucker.pp_cache_build",
                                     sparse_tucker_build_caches, st, Ws,
                                     mesh=mesh)
        W_init = [W for W in Ws]
        dWs = [jnp.zeros_like(W) for W in Ws]
        pp_sweeps = 0
        while it <= cfg.maxiter and pp_sweeps < 15:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                cn, dn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol,
                    1, history, mesh)
                cn_prev = jnp.asarray(cn, Ws[0].dtype)
                if (dn < cfg.tol and it > 0) or dtime > cfg.timelimit:
                    if core is None:
                        core = _sp_ttmc(st, list(Ws), -1, mesh)
                    return tkm.TuckerResult(Ws, core, dn, diffV, it,
                                            dn < cfg.tol, history)
            Ws, dWs, core, _stat = tracing.timed(
                "sparse_tucker.pp_sweep", tkm.tucker_pp_sweep, single,
                pair, Ws, W_init, dWs, ranks=ranks, subspace_iters=0)
            it += 1
            pp_sweeps += 1
            ratios = cpm._host_pull(cpm.factor_norm_ratios(Ws, dWs))
            if int(np.sum(np.abs(ratios) > tol_init)) > 0:
                break  # restart -> back to the exact phase
        # tol_init decay (als_Tucker.cxx:947-948)
        if tol_init > cfg.tol_init_floor:
            tol_init *= cfg.tol_init_decay
    if core is None:
        core = _sp_ttmc(st, list(Ws), -1, mesh)
    return tkm.TuckerResult(Ws, core, dn, diffV, it, dn < cfg.tol, history)
