"""Sparse CP-ALS solvers (COO tensors): plain ALS and pairwise
perturbation.

Reference: the ``-issparse`` path of the legacy drivers, which runs the
same alsCP / alsCP_PP algorithms on sparse CTF tensors
(test_ALS.cxx:126-131, 229). Scope here: the exact phase is PLAIN ALS
(exact sparse MTTKRP per mode) rather than the dimension tree — a DT on a
sparse tensor materializes dense O(s^(N-1) R) first-level intermediates,
which defeats sparse storage; the reference relies on CTF to make that
trade implicitly, here it is explicit and documented. PP sweeps and
restart logic are IDENTICAL to the dense engine (caches are dense either
way); only cache builds and exact sweeps touch the nonzeros.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pairwise_perturbation_tpu.models import cp as cpm
from pairwise_perturbation_tpu.ops import contract, solve
from pairwise_perturbation_tpu.ops import sparse as sp
from pairwise_perturbation_tpu.utils import tracing
from pairwise_perturbation_tpu.utils.metrics import PlotFile, SweepClock


@partial(jax.jit, static_argnames=("solver", "normalize", "mesh"))
def sparse_simple_sweep(st, Ws, lam, *, solver: str = "svd",
                        normalize: bool = True, mesh=None):
    """One plain ALS sweep with exact sparse MTTKRPs (alsCP body,
    als_CP.cxx:66-99, V sparse). With ``mesh`` (a 1D jax Mesh, static),
    the COO arrays are nnz-sharded and every MTTKRP runs as per-shard
    partials + one psum (parallel/mesh.sharded_sparse_mttkrp) — the
    distributed sparse CTF tensor analogue."""
    order = st.ndim
    Ws = list(Ws)
    for i in range(order):
        if mesh is not None:
            from pairwise_perturbation_tpu.parallel import mesh as pmesh
            M = pmesh.sharded_sparse_mttkrp(st, Ws, i, mesh)
        else:
            M = sp.mttkrp(st, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        Ws[i] = solve.solve(M, S, method=solver)
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws


@partial(jax.jit, static_argnames=("mesh",))
def sparse_pp_build_caches(st, Ws, *, mesh=None):
    if mesh is not None:
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        return pmesh.sharded_sparse_pp_caches(st, list(Ws), mesh)
    return sp.build_pp_caches(st, list(Ws))


@partial(jax.jit, static_argnames=("mesh",))
def sparse_diagnostics(V_norm_sq, st, Ws, lam=None, *, mesh=None):
    """(exact gradnorm, exact diffV) against the sparse tensor."""
    if mesh is not None:
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        gn = pmesh.sharded_sparse_gradnorm(st, list(Ws), mesh, regul=lam)
        M_last = pmesh.sharded_sparse_mttkrp(st, list(Ws), st.ndim - 1,
                                             mesh)
        dv = contract.cp_residual_norm(V_norm_sq, M_last, list(Ws))
        return gn, dv
    gn = sp.cp_gradnorm(st, list(Ws), regul=lam)
    dv = sp.cp_residual_norm(V_norm_sq, st, list(Ws))
    return gn, dv


def _diag_and_log(V_norm_sq, st, Ws, lam, clock, plot, it, tol, pp_flag,
                  history, mesh=None):
    jax.block_until_ready(Ws)
    with clock.exclude():
        gn, diffV = tracing.timed("sparse.diagnostics", sparse_diagnostics,
                                  V_norm_sq, st, Ws, lam, mesh=mesh)
        gn, diffV = float(gn), float(diffV)
    dtime = clock.dtime()
    if plot is not None:
        plot.row(st.shape[0], it, gn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, gradnorm=gn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return gn, diffV, dtime


def als_cp_sparse(st, Ws, cfg: cpm.CPConfig,
                  plot: Optional[PlotFile] = None,
                  clock: Optional[SweepClock] = None,
                  mesh=None) -> cpm.CPResult:
    """Plain sparse ALS (alsCP with a sparse V). ``mesh``: nnz-sharded
    COO over a 1D device mesh (see sparse_simple_sweep)."""
    Ws = [jnp.asarray(W) for W in Ws]
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
    lam = jnp.asarray(cfg.lam, dtype=Ws[0].dtype)
    with clock.exclude():
        cpm.warm_compile(sparse_simple_sweep, st, Ws, lam,
                         solver=cfg.solver, mesh=mesh)
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, st, Ws, lam, clock, plot, it, cfg.tol, 0,
                history, mesh)
            if gn < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws = tracing.timed("sparse.sweep", sparse_simple_sweep, st, Ws, lam,
                           solver=cfg.solver, mesh=mesh)
        it += 1
    return cpm.CPResult(Ws, gn, diffV, it, converged, history)


def als_cp_pp_sparse(st, Ws, cfg: cpm.CPConfig,
                     plot: Optional[PlotFile] = None,
                     clock: Optional[SweepClock] = None,
                     mesh=None) -> cpm.CPResult:
    """Sparse PP: exact phase = plain sparse sweeps with dW tracking (exit
    to PP when all modes quiet); PP phase = the dense engine's pp_sweep on
    sparse-built caches, with the reference's restart tolerance and
    15-sweep cap (alsCP_PP, als_CP.cxx:1082-1137)."""
    Ws = [jnp.asarray(W) for W in Ws]
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
    lam = jnp.asarray(cfg.lam, dtype=Ws[0].dtype)
    with clock.exclude():
        cpm.warm_compile(sparse_simple_sweep, st, Ws, lam,
                         solver=cfg.solver, mesh=mesh)
        cpm.warm_compile(sparse_pp_build_caches, st, Ws, mesh=mesh)
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    while it <= cfg.maxiter and gn > cfg.tol:
        # ---- exact phase (alsCP_DT_sub role) ----
        W_prev = [jnp.zeros_like(W) for W in Ws]
        quiet = False
        while it <= cfg.maxiter:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, lam, clock, plot, it, cfg.tol, 0,
                    history, mesh)
                if gn < cfg.tol or dtime > cfg.timelimit:
                    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol,
                                        history)
            Ws = tracing.timed("sparse.sweep", sparse_simple_sweep, st, Ws,
                               lam, solver=cfg.solver, mesh=mesh)
            dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
            W_prev = [W for W in Ws]
            ratios = cpm._host_pull(cpm.factor_norm_ratios(Ws, dWs))
            it += 1
            if int(np.sum(np.abs(ratios) < cfg.pp_res_tol)) == len(Ws):
                quiet = True
                break
        if not quiet or it > cfg.maxiter:
            break
        # ---- PP phase (alsCP_PP_sub) ----
        single, pair = tracing.timed("sparse.pp_cache_build",
                                     sparse_pp_build_caches, st, Ws,
                                     mesh=mesh)
        W_init = [W for W in Ws]
        dWs = [jnp.zeros_like(W) for W in Ws]
        pp_sweeps = 0
        while it <= cfg.maxiter and pp_sweeps < cfg.pp_cache_sweeps:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, lam, clock, plot, it, cfg.tol, 1,
                    history, mesh)
                if gn < cfg.tol or dtime > cfg.timelimit:
                    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol,
                                        history)
            Ws, dWs, _ = tracing.timed(
                "sparse.pp_sweep", cpm.pp_sweep, single, pair, Ws, W_init,
                dWs, lam, cfg.ratio_step, solver=cfg.solver)
            it += 1
            pp_sweeps += 1
            ratios = cpm._host_pull(cpm.factor_norm_ratios(Ws, dWs))
            if int(np.sum(np.abs(ratios) > cfg.pp_res_tol)) > 0:
                break  # restart -> back to the exact phase
    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol, history)
