"""Tucker decomposition: HOSVD init, HOOI (plain ALS), dimension-tree ALS,
and pairwise-perturbation ALS with SVD sign-fixing.

JAX re-design of the reference Tucker engine (als_Tucker.cxx):

- :func:`hosvd`            <-> ``hosvd`` / ``get_factor_matrices`` /
                               ``get_core_tensor`` (als_Tucker.cxx:12-70)
- :func:`als_tucker`       <-> ``alsTucker`` (HOOI, als_Tucker.cxx:120-176)
- :func:`als_tucker_dt`    <-> ``alsTucker_DT`` (als_Tucker.cxx:240-424)
- :func:`als_tucker_pp`    <-> ``alsTucker_PP`` = ``alsTucker_DT_sub`` <->
                               ``alsTucker_PP_sub`` machine with the
                               tol_init *= 0.9 decay (als_Tucker.cxx:476-962)

Factor updates take the leading r_i left singular vectors of the mode-i
unfolding of Y = TTMc(V, W, skip=i), computed via the s_i x s_i Gram +
eigh (the reference's unroll_tensor_contraction + ScaLAPACK SVD trick).
Column signs are aligned against the previous factors so that PP's dW
perturbations are meaningful (als_Tucker.cxx:632-643, 874-885).

Diagnostics use ||V - core x W||^2 = ||V||^2 - ||core||^2 (orthonormal W,
core = TTMc(V, W)) instead of full reconstruction (als_Tucker.cxx:296-311).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pairwise_perturbation_tpu.ops import contract, dimtree, solve
from pairwise_perturbation_tpu.utils import tracing
from pairwise_perturbation_tpu.utils.metrics import PlotFile, SweepClock


@dataclass
class TuckerConfig:
    tol: float = 1e-10
    pp_res_tol: float = 1e-2
    maxiter: int = 250
    timelimit: float = 5e3
    resprint: int = 1
    bench: bool = False
    tol_init_decay: float = 0.9      # als_Tucker.cxx:947-948
    tol_init_floor: float = 5e-3
    # Factor-extraction strategy: -1 = AUTO (default; warm-started
    # subspace iteration whenever the eigh side is large enough for it to
    # win — see _resolve_subspace_iters — exact eigh otherwise), 0 =
    # always exact (reference semantics), >0 = that many subspace
    # iterations. The subspace path is inexact per sweep but
    # self-correcting across sweeps (see AUTO_SUBSPACE_MIN_SIDE for the
    # measured crossover).
    subspace_iters: int = -1
    # Quiet-mode extraction skip inside PP sweeps: a mode whose OTHER
    # factors have all drifted < pp_quiet_frac * tol_init (relative
    # norm) since the cache build keeps its factor without recomputing
    # the corrected TTMc or the extraction (see tucker_pp_sweep).
    # DEFAULT 0 = OFF (reference semantics): measured NEGATIVE — the
    # skip can stall PP's compounding progress entirely (skipped modes
    # freeze dW, frozen dW keeps every mode quiet, the phase goes
    # stationary; on the order-6 low-rank fixture the skip-on run never
    # improved fitness and ended worse, results/TUCKER_PP.md `_skip`
    # row) and buys nothing where it doesn't stall (coil: within noise
    # of skip-off). The PP-auto warm extraction (PP_AUTO_SUBSPACE_*) is
    # what makes PP sweeps cheap; the skip is kept as an opt-in knob
    # with the stationarity exit guarding it against spinning.
    pp_quiet_frac: float = 0.0
    # ShardedLayout of a -mesh run (host-side only; see cp.CPConfig) —
    # the fused machine pins TTMc cache shardings from it.
    mesh_layout: object = None


@dataclass
class TuckerResult:
    factors: List
    core: object
    diffnorm: float
    diffV: float
    iters: int
    converged: bool
    history: list = field(default_factory=list)


class TuckerBinaryTreeSweep:
    """Lazy binary-tree TTMc cache: node (lo, hi) = V with every mode outside
    [lo, hi] contracted with its factor (axis positions preserved).

    Mirrors ``ttmc_map_DT`` (als_Tucker.cxx:178-230) including top-level
    nodes built directly from V.
    """

    def __init__(self, V, factors: Sequence, precision=None):
        self.V = V
        self.factors = list(factors)
        self.order = V.ndim
        self.precision = precision
        self.parent = dimtree.binary_parent_map(self.order)
        self._memo: Dict[Tuple[int, int], object] = {}

    def node(self, lo: int, hi: int):
        key = (lo, hi)
        if key in self._memo:
            return self._memo[key]
        order = self.order
        plo, phi = self.parent[key]
        if (plo, phi) == (0, order - 1):
            T = self.V
        else:
            T = self.node(plo, phi)
        to_contract = [m for m in range(plo, phi + 1) if not lo <= m <= hi]
        priority = contract.contraction_priority(self.V.shape)
        for m in contract.order_by_priority(to_contract, priority):
            T = contract.ttmc_contract_mode(T, self.factors[m], m,
                                            precision=self.precision)
        self._memo[key] = T
        return T

    def ttmc(self, i: int):
        """Y_i: all modes except i contracted."""
        return self.node(i, i)


# ---------------------------------------------------------------------------
# Jitted kernels
# ---------------------------------------------------------------------------


def _dot(a, b):
    """Matmul at the configured (HIGHEST) precision — plain ``@`` uses
    DEFAULT, which a GPU may run in TF32, and that measurably degrades
    the factor subspaces."""
    import pairwise_perturbation_tpu.config as _cfg
    return jnp.matmul(a, b, precision=_cfg.default_precision())


def _topk_subspace(G, r: int, Q0, iters: int):
    """Top-``r`` eigenpairs of PSD ``G`` by warm-started subspace iteration
    + Rayleigh-Ritz: a few skinny GEMMs and QRs plus an r x r eigh
    instead of an m x m eigh. ALS factor subspaces drift slowly between
    sweeps, so the previous factor is an excellent warm start. Returns
    (W[m, r], lam[r]) descending."""
    Q, _ = jnp.linalg.qr(_dot(G, Q0))
    for _ in range(max(iters - 1, 0)):
        Q, _ = jnp.linalg.qr(_dot(G, Q))
    B = _dot(Q.T, _dot(G, Q))
    lam, Wk = jnp.linalg.eigh(B)
    return _dot(Q, Wk[:, ::-1]), lam[::-1]


# AUTO thresholds (subspace_iters == -1): exact eigh cost grows cubically
# with the Gram side while two warm-started subspace iterations stay
# near-linear. On an H100 two warm iterations already beat eigh at side
# 64 and win 2.3x at 256 and 6x at 512 (chip_smoke.py phase B; PERF.md).
# The threshold stays at 256 all the same: the coil-100 Tucker modes 1
# and 2 (Gram side 128) would cross it, but whether fitness holds there
# with the inexact extraction is not measured yet (ROADMAP). The r-guard
# keeps the Rayleigh-Ritz basis overdetermined so the inexact extraction
# cannot lose leading directions.
AUTO_SUBSPACE_MIN_SIDE = 256
AUTO_SUBSPACE_ITERS = 2
# PP-phase AUTO thresholds: a PP sweep's Y is a first-order perturbation
# of the Y its warm basis was extracted from, so ONE warm-started
# iteration suffices and pays off at much smaller eigh sides (the
# reference's PP philosophy — perturb, don't recompute,
# als_Tucker.cxx:828-860 — applied to the extraction itself; VERDICT r4
# weak #2: coil Tucker PP sweeps were extraction-dominated).
PP_AUTO_SUBSPACE_MIN_SIDE = 64
PP_AUTO_SUBSPACE_ITERS = 1


def _resolve_subspace_iters(subspace_iters: int, side: int, r: int,
                            pp: bool = False) -> int:
    """Map the AUTO sentinel (-1) to a per-mode static decision: subspace
    iteration for large eigh sides, exact eigh otherwise (the fallback
    guard — small sides and wide ranks always take the exact path).
    ``pp``: resolve with the cheaper PP-phase thresholds."""
    if subspace_iters >= 0:
        return subspace_iters
    min_side = PP_AUTO_SUBSPACE_MIN_SIDE if pp else AUTO_SUBSPACE_MIN_SIDE
    iters = PP_AUTO_SUBSPACE_ITERS if pp else AUTO_SUBSPACE_ITERS
    if side >= min_side and 2 * r <= side:
        return iters
    return 0


def _factor_from_Y(Y, i: int, r: int, sign_ref=None, warm=None,
                   subspace_iters: int = 0, pp: bool = False):
    """Leading left singular vectors of the mode-i unfolding of Y,
    via Gram + eigh on the SMALLER side of the unfolding.

    The reference always Grams the mode side (unroll_tensor_contraction +
    ScaLAPACK SVD, als_Tucker.cxx:12-23); for a tall unfolding A (s_i x m)
    with m << s_i — e.g. coil-100 mode 7200 after the other modes are
    rank-reduced to 3*10*10=300 — that is an s_i^2 Gram plus an s_i^2
    eigh (seconds on one chip). Gramming the small side instead
    (G = A^T A, m x m) and recovering U = A W diag(1/sigma) is
    algebraically the same truncated SVD at O(s_i m^2).

    With ``subspace_iters > 0`` and a ``warm`` basis (the previous sweep's
    factor), the eigh is replaced by warm-started subspace iteration
    (:func:`_topk_subspace`) — inexact but self-correcting across HOOI
    sweeps; opt-in (TuckerConfig.subspace_iters).
    Deterministic column signs, optionally aligned to ``sign_ref``."""
    s_i = Y.shape[i]
    m = Y.size // s_i
    side = m if r <= m < s_i else s_i   # the eigh side actually used below
    subspace_iters = _resolve_subspace_iters(subspace_iters, side, r, pp)
    fast = subspace_iters > 0 and warm is not None
    if r <= m < s_i:
        # unfold to (s_i, m): mode i first, remaining axes in order.
        # (r > m falls through to the mode-side eigh, whose orthonormal
        # completion supplies the extra columns.)
        perm = (i,) + tuple(ax for ax in range(Y.ndim) if ax != i)
        A = jnp.transpose(Y, perm).reshape(s_i, m)
        G = _dot(A.T, A)                             # (m, m)
        if fast and r < m:
            W, lam = _topk_subspace(G, r, _dot(A.T, warm), subspace_iters)
        else:
            W, lam = solve.truncated_eigh(G, r)      # top-r eigenvalues
        # relative clamp: near-null directions would otherwise be scaled
        # by rsqrt of rounding noise into garbage columns
        floor = 1e-12 * jnp.maximum(lam[0], 1e-30)
        inv_sigma = jnp.where(lam > floor, jax.lax.rsqrt(
            jnp.maximum(lam, floor)), 0.0)
        U = _dot(A, W) * inv_sigma[None, :]
    else:
        G = contract.mode_gram(Y, i)
        if fast and r < s_i:
            U, _ = _topk_subspace(G, r, warm, subspace_iters)
        else:
            U, _ = solve.truncated_eigh(G, r)
    U = solve.fix_sign_columns(U)
    if sign_ref is not None:
        U = solve.sign_match(U, sign_ref)
    return U


@partial(jax.jit, static_argnames=("ranks", "use_sign", "subspace_iters"))
def tucker_dt_sweep(V, Ws, sign_refs, *, ranks: Tuple[int, ...],
                    use_sign: bool, subspace_iters: int = 0):
    """One DT Tucker sweep: per-mode tree TTMc -> Gram -> eigh -> sign fix;
    core from the last mode's Y (als_Tucker.cxx:342-408, 568-645).
    Returns (Ws_new, core). ``subspace_iters`` > 0 replaces the exact
    eigh with warm-started subspace iteration (previous factor as the
    start basis) — faster factor extraction for large Gram sides."""
    order = V.ndim
    Ws = list(Ws)
    sweep = TuckerBinaryTreeSweep(V, Ws)
    Y_end = None
    for i in range(order):
        Y = sweep.ttmc(i)
        if i == order - 1:
            Y_end = Y
        ref = sign_refs[i] if use_sign else None
        U = _factor_from_Y(Y, i, ranks[i], ref, warm=sign_refs[i],
                           subspace_iters=subspace_iters)
        sweep.factors[i] = U
    Ws = sweep.factors
    core = contract.ttmc_contract_mode(Y_end, Ws[order - 1], order - 1)
    return Ws, core


@partial(jax.jit, static_argnames=("ranks",))
def tucker_hooi_sweep(V, Ws, *, ranks: Tuple[int, ...]):
    """One plain HOOI sweep (alsTucker body, als_Tucker.cxx:148-163)."""
    order = V.ndim
    Ws = list(Ws)
    for i in range(order):
        Y = contract.ttmc(V, Ws, skip_mode=i)
        Ws[i] = _factor_from_Y(Y, i, ranks[i])
    core = contract.ttmc(V, Ws, skip_mode=-1)
    return Ws, core


@jax.jit
def tucker_build_caches(V, Ws):
    return contract.build_ttmc_caches(V, Ws)


@partial(jax.jit, static_argnames=("ranks", "subspace_iters"))
def tucker_pp_sweep(single, pair, Ws, W_init, dWs, quiet_tol=0.0, age=0, *,
                    ranks: Tuple[int, ...], subspace_iters: int = 0):
    """One PP Tucker sweep (als_Tucker.cxx:823-891): corrected TTMc from
    caches, factor update, sign fix vs W_init, cumulative dW.
    Returns (Ws_new, dWs_new, core, stationary) — ``stationary`` is True
    when EVERY mode was quiet-skipped: the sweep was a no-op (the PP
    fixed point of this cache is reached) and the phase should exit to
    the exact machine instead of spinning to the sweep cap.

    Extraction economics (VERDICT r4 weak #2 — the PP sweep must not
    recompute what barely moved):

    - AUTO extraction (``subspace_iters == -1``) resolves with the
      cheaper PP thresholds (1 warm-started iteration from the phase
      anchor ``W_init`` at eigh sides >= 64).
    - QUIET-MODE SKIP: with ``quiet_tol > 0`` and ``age > 0`` (not the
      first sweep after a cache build), a mode whose OTHER factors have
      all drifted < ``quiet_tol`` relative norm since the build keeps
      its factor without recomputing Y or the extraction — its corrected
      Y is within O(quiet_tol) of the Y it was last extracted from
      (dW is anchored at the build, so the bound needs no extra state).
      The Tucker analogue of alsCP_PP_partupdate's relative-perturbation
      ranking (als_CP.cxx:992-1001). ``quiet_tol = 0`` reproduces
      reference semantics exactly.
    """
    order = len(Ws)
    Ws = list(Ws)
    dWs = list(dWs)
    tiny = jnp.asarray(1e-30, Ws[0].dtype)
    # sweep-start drift of each factor since the cache build
    rel = jnp.stack([jnp.linalg.norm(d) /
                     jnp.maximum(jnp.linalg.norm(w), tiny)
                     for d, w in zip(dWs, Ws)])
    Y_end = None
    stationary = jnp.asarray(True)
    for i in range(order):
        others = jnp.max(rel.at[i].set(0.0))
        quiet = (jnp.asarray(age) > 0) & (others < quiet_tol)
        stationary = stationary & quiet
        last = i == order - 1

        def extract_from(Y, i=i):
            return _factor_from_Y(Y, i, ranks[i], W_init[i],
                                  warm=W_init[i],
                                  subspace_iters=subspace_iters, pp=True)

        if last:
            # the core always needs the corrected last-mode Y (diffnorm),
            # so only the extraction is conditional here
            Y_end = contract.pp_correct_ttmc(single[i], pair, dWs, i)
            U = jax.lax.cond(quiet, lambda _: Ws[i],
                             lambda _: extract_from(Y_end), None)
        else:
            # quiet modes skip the corrected TTMc AND the extraction
            U = jax.lax.cond(
                quiet, lambda _: Ws[i],
                lambda _, i=i: extract_from(
                    contract.pp_correct_ttmc(single[i], pair, dWs, i)),
                None)
        Ws[i] = U
        dWs[i] = U - W_init[i]
    core = contract.ttmc_contract_mode(Y_end, Ws[order - 1], order - 1)
    return Ws, dWs, core, stationary


@jax.jit
def tucker_diagnostics(V_norm_sq, V, Ws, core_prev_norm):
    """(core_fresh, core_norm, diffnorm, diffV) with
    diffV^2 = ||V||^2 - ||core||^2 (orthonormal factors)."""
    core = contract.ttmc(V, Ws, skip_mode=-1)
    cn = jnp.linalg.norm(core.ravel())
    diffnorm = jnp.abs(cn - core_prev_norm)
    diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
    return core, cn, diffnorm, diffV


# ---------------------------------------------------------------------------
# HOSVD
# ---------------------------------------------------------------------------


# HOSVD factor extraction: exact eigh up to this Gram side; above it, a
# randomized oversampled subspace iteration (deterministic key). XLA's
# eigh at e.g. 7200^2 is O(s^3) and was a compile-side blow-up on the
# accelerator this code was first written for;
# 4 subspace iterations at 2x oversampling recover the leading subspace
# to init accuracy — HOOI self-corrects from there (the reference's
# exact-HOSVD init, als_Tucker.cxx:66-70, differs only in this start).
HOSVD_EXACT_EIGH_MAX = 4096


@partial(jax.jit, static_argnames=("ranks",))
def _hosvd_jit(V, *, ranks: Tuple[int, ...]):
    order = V.ndim
    Ws = []
    for i in range(order):
        G = contract.mode_gram(V, i)
        s_i = V.shape[i]
        q = min(2 * ranks[i], s_i)
        if s_i > HOSVD_EXACT_EIGH_MAX and q < s_i:
            Q0 = jax.random.normal(jax.random.PRNGKey(17 + i), (s_i, q),
                                   dtype=G.dtype)
            U, _ = _topk_subspace(G, ranks[i], Q0, iters=4)
            U = U[:, :ranks[i]]
        else:
            U, _ = solve.truncated_eigh(G, ranks[i])
        Ws.append(solve.fix_sign_columns(U))
    core = contract.ttmc(V, Ws, skip_mode=-1)
    return Ws, core


def hosvd(V, ranks: Sequence[int]):
    """HOSVD initialization (als_Tucker.cxx:66-70). Returns (core, factors)."""
    Ws, core = _hosvd_jit(jnp.asarray(V), ranks=tuple(int(r) for r in ranks))
    return core, Ws


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _diag_and_log(V_norm_sq, V, Ws, core_prev_norm, clock, plot, it, tol,
                  pp_flag, history):
    # sync queued sweeps BEFORE the excluded window: the queue drain is
    # sweep time and stays counted (models/cp.py)
    jax.block_until_ready(Ws)
    with clock.exclude():
        core, cn, diffnorm, diffV = tracing.timed(
            "tucker.diagnostics", tucker_diagnostics,
            V_norm_sq, V, Ws, core_prev_norm)
        cn, diffnorm, diffV = float(cn), float(diffnorm), float(diffV)
    dtime = clock.dtime()
    if plot is not None:
        plot.row(V.shape[0], it, diffnorm, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, diffnorm=diffnorm, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return core, cn, diffnorm, diffV, dtime


def als_tucker(V, ranks, cfg: TuckerConfig,
               plot: Optional[PlotFile] = None,
               Ws: Optional[List] = None, use_tree: bool = True,
               clock: Optional[SweepClock] = None) -> TuckerResult:
    """Tucker ALS (HOOI); ``use_tree`` selects the DT variant.

    Reference: alsTucker (als_Tucker.cxx:120-176) / alsTucker_DT
    (als_Tucker.cxx:240-424). Initialized by HOSVD like the driver
    (test_ALS.cxx:386-395).
    """
    V = jnp.asarray(V)
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = contract.norm_sq(V)
    if Ws is None:
        core, Ws = tracing.timed("tucker.hosvd", hosvd, V, ranks)
    else:
        Ws = [jnp.asarray(W) for W in Ws]
        core = contract.ttmc(V, Ws, skip_mode=-1)
    clock = clock or SweepClock()
    from pairwise_perturbation_tpu.models.cp import warm_compile
    with clock.exclude():
        if use_tree:
            warm_compile(tucker_dt_sweep, V, Ws, Ws, ranks=ranks,
                         use_sign=False, subspace_iters=cfg.subspace_iters)
        else:
            warm_compile(tucker_hooi_sweep, V, Ws, ranks=ranks)
    history: list = []
    core_prev_norm = jnp.linalg.norm(core.ravel())
    diffnorm, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if (it % cfg.resprint == 0 and it != 0) or it == 1 or it == cfg.maxiter:
            core, core_prev_norm, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, core_prev_norm, clock, plot, it, cfg.tol, 0,
                history)
            if diffnorm < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        if use_tree:
            Ws, core = tracing.timed(
                "tucker.dt_sweep", tucker_dt_sweep, V, Ws, Ws, ranks=ranks,
                use_sign=False, subspace_iters=cfg.subspace_iters)
        else:
            Ws, core = tracing.timed("tucker.hooi_sweep", tucker_hooi_sweep,
                                     V, Ws, ranks=ranks)
        it += 1
    return TuckerResult(Ws, core, diffnorm, diffV, it, converged, history)


def _tucker_dt_sub(V, Ws, dWs, ranks, cfg, plot, clock, state, V_norm_sq):
    """alsTucker_DT_sub (als_Tucker.cxx:476-669)."""
    order = V.ndim
    W_prev = [jnp.zeros_like(W) for W in Ws]
    from pairwise_perturbation_tpu.models.cp import warm_compile
    with clock.exclude():
        warm_compile(tucker_dt_sweep, V, Ws, W_prev, ranks=ranks,
                     use_sign=True, subspace_iters=cfg.subspace_iters)
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        if (it % cfg.resprint == 0 and it != 0) or it == 1 or it == cfg.maxiter:
            core, cn, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, state["core_prev_norm"], clock, plot, it,
                cfg.tol, 0, state["history"])
            state.update(core=core, core_prev_norm=cn, diffnorm=diffnorm,
                         diffV=diffV)
            if diffnorm < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws_new, core = tracing.timed(
            "tucker.dt_sweep", tucker_dt_sweep, V, Ws, W_prev, ranks=ranks,
            use_sign=True, subspace_iters=cfg.subspace_iters)
        state["core"] = core
        dWs = [W - Wp for W, Wp in zip(Ws_new, W_prev)]
        W_prev = [W for W in Ws_new]
        Ws = Ws_new
        from pairwise_perturbation_tpu.models.cp import (_host_pull,
                                                         factor_norm_ratios)
        ratios = _host_pull(factor_norm_ratios(Ws, dWs))
        state["iter"] = it + 1
        if int(np.sum(np.abs(ratios) < state["tol_init"])) == order:
            return Ws, dWs, "quiet"
    return Ws, dWs, "maxiter"


def _tucker_pp_sub(V, Ws, dWs, ranks, cfg, plot, clock, state, V_norm_sq):
    """alsTucker_PP_sub (als_Tucker.cxx:679-896)."""
    order = V.ndim
    init_iter = state["iter"]
    W_init = None
    single = pair = None
    from pairwise_perturbation_tpu.models.cp import (_host_pull,
                                                     factor_norm_ratios,
                                                     warm_compile)
    if not state.get("pp_warmed"):
        # one-time per solve; the warm build is reused as the first
        # in-loop build (factors unchanged in between) — see models/cp.py
        with clock.exclude():
            s_w, p_w = jax.block_until_ready(tucker_build_caches(V, Ws))
            zeros = [jnp.zeros_like(W) for W in Ws]
            warm_compile(tucker_pp_sweep, s_w, p_w, list(Ws), list(Ws),
                         zeros, jnp.asarray(0.0, Ws[0].dtype),
                         jnp.asarray(0), ranks=ranks,
                         subspace_iters=cfg.subspace_iters)
            state["warm_caches"] = (s_w, p_w)
            state["pp_warmed"] = True
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        num_dw_break = 0
        if not cfg.bench:
            ratios = _host_pull(factor_norm_ratios(Ws, dWs))
            num_dw_break = int(np.sum(np.abs(ratios) > state["tol_init"]))
        if it == init_iter or num_dw_break > 0:
            if num_dw_break > 0:
                return Ws, dWs, "restart"
            W_init = [W for W in Ws]
            dWs = [jnp.zeros_like(W) for W in Ws]
            build_it = it
            warm = state.pop("warm_caches", None)
            if warm is not None:
                single, pair = warm  # built from these exact factors
            else:
                single, pair = tracing.timed("tucker.pp_cache_build",
                                             tucker_build_caches, V, Ws)
        if (it % cfg.resprint == 0 and it != 0) or it == 1 \
                or it == cfg.maxiter or it == init_iter:
            core, cn, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, state["core_prev_norm"], clock, plot, it,
                cfg.tol, 1, state["history"])
            state.update(core=core, core_prev_norm=cn, diffnorm=diffnorm,
                         diffV=diffV)
            if diffnorm < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
            if it == cfg.maxiter:
                return Ws, dWs, "maxiter"
        quiet_tol = jnp.asarray(cfg.pp_quiet_frac * state["tol_init"],
                                Ws[0].dtype)
        Ws, dWs, core, stationary = tracing.timed(
            "tucker.pp_sweep", tucker_pp_sweep, single, pair, Ws, W_init,
            dWs, quiet_tol, jnp.asarray(it - build_it),
            subspace_iters=cfg.subspace_iters, ranks=ranks)
        state["core"] = core
        state["iter"] = it + 1
        # cfg.pp_quiet_frac == 0 (default): stationary is statically
        # False — short-circuit so the default path never pays this
        # extra device sync inside the timed loop
        if cfg.pp_quiet_frac and bool(_host_pull(stationary)):
            # every mode quiet-skipped: the PP fixed point of this cache
            # is reached — exit to the exact machine, don't spin
            return Ws, dWs, "restart"
    return Ws, dWs, "maxiter"


def als_tucker_pp(V, ranks, cfg: TuckerConfig,
                  plot: Optional[PlotFile] = None,
                  Ws: Optional[List] = None,
                  clock: Optional[SweepClock] = None) -> TuckerResult:
    """Outer Tucker DT <-> PP loop with tol_init decay
    (alsTucker_PP, als_Tucker.cxx:906-962)."""
    V = jnp.asarray(V)
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = contract.norm_sq(V)
    if Ws is None:
        core, Ws = tracing.timed("tucker.hosvd", hosvd, V, ranks)
    else:
        Ws = [jnp.asarray(W) for W in Ws]
        core = contract.ttmc(V, Ws, skip_mode=-1)
    clock = clock or SweepClock()
    state = dict(iter=0, core=core,
                 core_prev_norm=jnp.linalg.norm(core.ravel()),
                 diffnorm=float("inf"), diffV=float("inf"),
                 tol_init=cfg.pp_res_tol, history=[])
    dWs = [jnp.zeros_like(W) for W in Ws]
    reason = None
    while state["diffnorm"] > cfg.tol and state["iter"] <= cfg.maxiter:
        if not cfg.bench:
            Ws, dWs, reason = _tucker_dt_sub(V, Ws, dWs, ranks, cfg, plot,
                                             clock, state, V_norm_sq)
            if reason in ("converged", "timelimit", "maxiter"):
                break
        Ws, dWs, reason = _tucker_pp_sub(V, Ws, dWs, ranks, cfg, plot, clock,
                                         state, V_norm_sq)
        if reason in ("converged", "timelimit", "maxiter"):
            break
        if cfg.bench:
            break
        if state["tol_init"] > cfg.tol_init_floor:
            state["tol_init"] *= cfg.tol_init_decay
    return TuckerResult(Ws, state["core"], state["diffnorm"], state["diffV"],
                        state["iter"], reason == "converged",
                        state["history"])


# ---------------------------------------------------------------------------
# Device-resident phase loops (lax.while_loop) — see models/cp.py for the
# rationale: one host sync per phase instead of per sweep.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("ranks", "max_sweeps",
                                   "subspace_iters"))
def tucker_dt_phase_device(V, Ws, tol_init, diff_tol, it_budget,
                           *, ranks: Tuple[int, ...], max_sweeps: int = 256,
                           subspace_iters: int = 0):
    """DT Tucker sweeps on device until all modes quiet / diffnorm < tol /
    budget. Returns (n, Ws, dWs, core, diffnorm, quiet, hist[max_sweeps,2])
    with hist rows = [diffnorm, diffV_est]."""
    V_norm_sq = contract.norm_sq(V)

    def body(carry):
        k, Ws, W_prev, dWs, cn_prev, dn, quiet, core, hist = carry
        Ws2, core2 = tucker_dt_sweep(V, list(Ws), list(W_prev), ranks=ranks,
                                     use_sign=True,
                                     subspace_iters=subspace_iters)
        dWs2 = tuple(a - b for a, b in zip(Ws2, W_prev))
        from pairwise_perturbation_tpu.models.cp import factor_norm_ratios
        ratios = factor_norm_ratios(list(Ws2), list(dWs2))
        quiet2 = jnp.all(jnp.abs(ratios) < tol_init)
        cn = jnp.linalg.norm(core2.ravel())
        dn2 = jnp.abs(cn - cn_prev)
        diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
        hist = hist.at[k].set(jnp.stack([dn2, diffV]))
        return (k + 1, tuple(Ws2), tuple(Ws2), dWs2, cn, dn2, quiet2, core2,
                hist)

    def cond(carry):
        k, _, _, _, _, dn, quiet, _, _ = carry
        return (k < it_budget) & jnp.logical_not(quiet) & (dn >= diff_tol)

    core0 = contract.ttmc(V, list(Ws), skip_mode=-1)
    hist0 = jnp.zeros((max_sweeps, 2), V.dtype)
    zeros = tuple(jnp.zeros_like(W) for W in Ws)
    init = (jnp.asarray(0), tuple(Ws), zeros, zeros,
            jnp.linalg.norm(core0.ravel()),
            jnp.asarray(jnp.inf, V.dtype), jnp.asarray(False), core0, hist0)
    k, Ws_f, _, dWs_f, cn, dn, quiet, core, hist = jax.lax.while_loop(
        cond, body, init)
    return k, list(Ws_f), list(dWs_f), core, dn, quiet, hist


@partial(jax.jit, static_argnames=("ranks", "max_sweeps",
                                   "subspace_iters", "resprint",
                                   "n_slots"))
def tucker_pp_phase_device(V, Ws, tol_init, diff_tol, it_budget, it0=0,
                           quiet_tol=0.0,
                           *, ranks: Tuple[int, ...], max_sweeps: int = 64,
                           subspace_iters: int = 0, resprint: int = 0,
                           n_slots: int = 0):
    """PP Tucker sweeps on device until the restart tolerance trips /
    diffnorm < tol / budget. Returns (n, Ws, dWs, core, diffnorm, hist,
    snaps, snap_labels, snap_count).

    Like cp.pp_phase_device (round-5 accounting): the per-sweep core
    comes from the PP-approximate TTMc (first-order in dW); rows the
    host will log ((it0 + k) % resprint == 0) snapshot the factors into
    the ring, and the HOST recomputes the exact core norm / diffV from
    them after the phase, inside its excluded window — the timed
    dispatch never pays the diagnostic TTMc (als_CP.cxx:474-482
    accounting)."""
    from pairwise_perturbation_tpu.models.cp import (_snap_ring_init,
                                                     _snap_ring_write,
                                                     factor_norm_ratios)
    V_norm_sq = contract.norm_sq(V)
    single, pair = contract.build_ttmc_caches(V, list(Ws))
    W_init = tuple(Ws)

    def body(carry):
        k, Ws, dWs, cn_prev, dn, broke, core, hist, snaps, labels, n = carry
        Ws2, dWs2, core2, stat2 = tucker_pp_sweep(
            single, pair, list(Ws), list(W_init), list(dWs),
            quiet_tol, k, ranks=ranks, subspace_iters=subspace_iters)
        ratios = factor_norm_ratios(list(Ws2), list(dWs2))
        broke2 = jnp.any(jnp.abs(ratios) > tol_init) | stat2
        cn = jnp.linalg.norm(core2.ravel())
        if resprint:
            logged = jnp.mod(it0 + k, resprint) == 0
            snaps, labels, n = _snap_ring_write(
                it0 + k, Ws2, snaps, labels, n, n_slots, logged)
        dn2 = jnp.abs(cn - cn_prev)
        diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
        hist = hist.at[k].set(jnp.stack([dn2, diffV]))
        return (k + 1, tuple(Ws2), tuple(dWs2), cn, dn2, broke2, core2,
                hist, snaps, labels, n)

    def cond(carry):
        k, _, _, _, dn, broke, _, _, _, _, _ = carry
        return (k < it_budget) & jnp.logical_not(broke) & (dn >= diff_tol)

    core0 = contract.ttmc(V, list(Ws), skip_mode=-1)
    hist0 = jnp.zeros((max_sweeps, 2), V.dtype)
    zeros = tuple(jnp.zeros_like(W) for W in Ws)
    init = (jnp.asarray(0), tuple(Ws), zeros,
            jnp.linalg.norm(core0.ravel()),
            jnp.asarray(jnp.inf, V.dtype), jnp.asarray(False), core0,
            hist0) + _snap_ring_init(Ws, n_slots)
    (k, Ws_f, dWs_f, cn, dn, broke, core, hist, snaps, labels,
     n) = jax.lax.while_loop(cond, body, init)
    return k, list(Ws_f), list(dWs_f), core, dn, hist, snaps, labels, n


def als_tucker_pp_device(V, ranks, cfg: TuckerConfig,
                         plot: Optional[PlotFile] = None,
                         Ws: Optional[List] = None,
                         clock: Optional[SweepClock] = None) -> TuckerResult:
    """Device-resident Tucker DT <-> PP machine with tol_init decay."""
    V = jnp.asarray(V)
    ranks = tuple(int(r) for r in ranks)
    if Ws is None:
        core, Ws = tracing.timed("tucker.hosvd", hosvd, V, ranks)
    else:
        Ws = [jnp.asarray(W) for W in Ws]
        core = contract.ttmc(V, Ws, skip_mode=-1)
    clock = clock or SweepClock()
    V_norm_sq = contract.norm_sq(V)
    tol_init = cfg.pp_res_tol
    history: list = []
    it = 0
    dn = float("inf")
    diffV = float("inf")
    # snapshot ring slots: enough for every logged row of one PP phase
    n_slots = (cfg.maxiter // max(cfg.resprint, 1)) + 3

    # compile warm-up with zero sweep budgets, then start the clock
    _w1 = tucker_dt_phase_device(
        V, Ws, jnp.asarray(tol_init, V.dtype), jnp.asarray(cfg.tol, V.dtype),
        jnp.asarray(0), ranks=ranks, max_sweeps=cfg.maxiter + 1,
        subspace_iters=cfg.subspace_iters)
    _w2 = tucker_pp_phase_device(
        V, Ws, jnp.asarray(tol_init, V.dtype), jnp.asarray(cfg.tol, V.dtype),
        jnp.asarray(0), jnp.asarray(0),
        jnp.asarray(cfg.pp_quiet_frac * tol_init, V.dtype), ranks=ranks,
        max_sweeps=cfg.maxiter + 1, subspace_iters=cfg.subspace_iters,
        resprint=cfg.resprint, n_slots=n_slots)
    from pairwise_perturbation_tpu.models.cp import _host_pull
    jax.block_until_ready((_w1[3], _w2[3]))
    clock.reset()

    cn_by_it: dict = {}  # exact core norms of logged rows (for exact dn)

    def _log(hist, n, pp_flag, t0, t1, snaps=None, labels=None,
             snap_n=None):
        nonlocal it, dn, diffV
        # full-buffer pull + host slice (device slices recompile per n)
        h = np.asarray(jax.device_get(hist))[:n]
        # EXACT core norm / diffV for logged PP rows, from the phase's
        # factor snapshots — computed in the excluded window so the
        # timed dispatch never paid the diagnostic TTMc
        exact: dict = {}
        if snaps is not None:
            with clock.exclude():
                sn = int(np.asarray(snap_n))
                if sn > 0:
                    labels_h = np.asarray(jax.device_get(labels))
                    for slot in range(min(sn, n_slots)):
                        Ws_s = [s_[slot] for s_ in snaps]
                        cn_s = float(jnp.linalg.norm(contract.ttmc(
                            V, Ws_s, skip_mode=-1).ravel()))
                        exact[int(labels_h[slot])] = cn_s
        for i in range(n):
            dn, diffV = float(h[i, 0]), float(h[i, 1])
            dt_row = t0 + (t1 - t0) * (i + 1) / max(n, 1)
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                if it in exact:
                    cn_s = exact[it]
                    cn_by_it[it] = cn_s
                    diffV = float(np.sqrt(max(
                        float(V_norm_sq) - cn_s * cn_s, 0.0)))
                    prev = [v for k_, v in cn_by_it.items() if k_ < it]
                    if prev:
                        dn = abs(cn_s - prev[-1])
                elif pp_flag == 0:
                    # DT rows carry the exact core norm already
                    cn_by_it[it] = float(np.sqrt(max(
                        float(V_norm_sq) - diffV * diffV, 0.0)))
                if plot is not None:
                    plot.row(V.shape[0], it, dn, cfg.tol, pp_flag, diffV,
                             dt_row)
                history.append(dict(iter=it, diffnorm=dn, diffV=diffV,
                                    dtime=dt_row, pp=pp_flag))
            it += 1

    while it <= cfg.maxiter:
        t0 = clock.dtime()
        budget = jnp.asarray(cfg.maxiter + 1 - it)
        n, Ws, dWs, core, dn_d, quiet, hist = tucker_dt_phase_device(
            V, Ws, jnp.asarray(tol_init, V.dtype),
            jnp.asarray(cfg.tol, V.dtype), budget, ranks=ranks,
            max_sweeps=cfg.maxiter + 1,
            subspace_iters=cfg.subspace_iters)
        n = int(_host_pull(n))
        t1 = clock.dtime()
        _log(hist, n, 0, t0, t1)
        if float(dn_d) < cfg.tol or it > cfg.maxiter or t1 > cfg.timelimit:
            dn = float(dn_d)
            break
        t0 = clock.dtime()
        budget = jnp.asarray(cfg.maxiter + 1 - it)
        (n, Ws, dWs, core, dn_d, hist, snaps, labels,
         snap_n) = tucker_pp_phase_device(
            V, Ws, jnp.asarray(tol_init, V.dtype),
            jnp.asarray(cfg.tol, V.dtype), budget, jnp.asarray(it),
            jnp.asarray(cfg.pp_quiet_frac * tol_init, V.dtype),
            ranks=ranks, max_sweeps=cfg.maxiter + 1,
            subspace_iters=cfg.subspace_iters, resprint=cfg.resprint,
            n_slots=n_slots)
        n = int(_host_pull(n))
        t1 = clock.dtime()
        _log(hist, n, 1, t0, t1, snaps, labels, snap_n)
        dn = float(dn_d)
        if dn < cfg.tol or t1 > cfg.timelimit:
            break
        if tol_init > cfg.tol_init_floor:
            tol_init *= cfg.tol_init_decay
    return TuckerResult(Ws, core, dn, diffV, it, dn < cfg.tol, history)


# ---------------------------------------------------------------------------
# Fully-fused device-resident Tucker solver (single dispatch per chunk) —
# the Tucker analogue of cp.pp_fused_chunk: the whole alsTucker_PP outer
# machine (DT sweeps with sign-fixing, TTMc cache builds, PP sweeps,
# restart tolerance, tol_init decay) inside one lax.while_loop with a
# 3-way phase switch. Reference: alsTucker_PP (als_Tucker.cxx:906-962).
# ---------------------------------------------------------------------------


def _tucker_pair_keys(order: int):
    return [(i, j) for i in range(order) for j in range(i + 1, order)]


def tucker_fused_init(V, Ws, ranks, max_hist: int, n_slots: int = 0):
    """Initial carry for :func:`tucker_fused_chunk`."""
    order = V.ndim
    dtype = Ws[0].dtype
    zeros = tuple(jnp.zeros_like(W) for W in Ws)

    def cache_shape(keep):
        return tuple(V.shape[m] if m in keep else ranks[m]
                     for m in range(order))

    single0 = tuple(jnp.zeros(cache_shape((i,)), dtype)
                    for i in range(order))
    pair0 = tuple(jnp.zeros(cache_shape((i, j)), dtype)
                  for (i, j) in _tucker_pair_keys(order))
    core0 = contract.ttmc(V, list(Ws), skip_mode=-1)
    hist0 = jnp.zeros((max_hist, 3), dtype)
    snaps0 = tuple(jnp.zeros((max(n_slots, 1),) + W.shape, dtype)
                   for W in Ws)
    return (jnp.asarray(0),                    # it
            jnp.asarray(0),                    # phase 0 DT / 1 build / 2 PP
            jnp.asarray(0),                    # cache_age
            tuple(Ws), zeros, zeros, tuple(Ws),  # Ws, W_prev, dWs, W_init
            single0, pair0,
            jnp.linalg.norm(core0.ravel()),    # cn_prev
            jnp.asarray(jnp.inf, dtype),       # dn
            core0,
            jnp.asarray(False),                # stop
            hist0,
            snaps0,                            # factor snaps on logged rows
            jnp.zeros((max(n_slots, 1),), jnp.int32) - 1,  # snap labels
            jnp.asarray(0))                    # snap count


@partial(jax.jit, static_argnames=("ranks", "subspace_iters", "chunk",
                                   "resprint", "pp_cap", "max_hist",
                                   "n_slots", "single_specs", "pair_specs"))
def tucker_fused_chunk(V, carry, tol_init0, diff_tol, maxiter,
                       decay, floor, quiet_frac=0.0,
                       *, ranks: Tuple[int, ...],
                       subspace_iters: int = 0, chunk: int = 64,
                       resprint: int = 1, pp_cap: int = 15,
                       max_hist: int = 512, n_slots: int = 0,
                       single_specs=None, pair_specs=None):
    """Advance the fused Tucker DT<->PP machine by up to ``chunk`` steps.

    tol_init decays by ``decay`` (to ``floor``) on each PP->DT
    transition, the fused equivalent of the outer-loop decay
    (als_Tucker.cxx:947-948); it rides as the last element of the traced
    state tuple (appended by the driver).

    Rows the host will log (label % resprint == 0, label >= maxiter)
    snapshot the factors into the carry's ring buffer; the host computes
    EXACT (core norm, diffV) from the snapshots AFTER the chunk inside
    the excluded-diagnostics window, so the timed path never pays the
    extra TTMc chain (reference excluded-MPI_Wtime accounting,
    als_Tucker.cxx:167-186). In-loop stats are the sweep's own core-norm
    estimate (exact in DT phases, PP-corrected during PP phases).
    """
    order = V.ndim
    V_norm_sq = contract.norm_sq(V)
    keys = _tucker_pair_keys(order)

    def write_hist(hist, label, dn_l, dv_l, ppflag):
        idx = jnp.minimum(label, max_hist - 1)
        return hist.at[idx].set(
            jnp.stack([dn_l, dv_l, jnp.asarray(ppflag, dn_l.dtype)]))

    def maybe_snap(label, Ws2, snaps, snap_labels, snap_n):
        if not resprint or not n_slots:
            return snaps, snap_labels, snap_n
        logged = (jnp.mod(label, resprint) == 0) | (label >= maxiter)

        def write(args):
            snaps, labels, n = args
            idx = jnp.minimum(n, n_slots - 1)
            snaps2 = tuple(s.at[idx].set(w) for s, w in zip(snaps, Ws2))
            return snaps2, labels.at[idx].set(label.astype(jnp.int32)), n + 1

        return jax.lax.cond(logged, write, lambda a: a,
                            (snaps, snap_labels, snap_n))

    from pairwise_perturbation_tpu.models.cp import factor_norm_ratios

    def dt_branch(st):
        (it, phase, age, Ws, W_prev, dWs, W_init, single, pair_t, cn_prev,
         dn, core, stop, hist, snaps, snap_labels, snap_n, tol_init) = st
        Ws2, core2 = tucker_dt_sweep(V, list(Ws), list(W_prev), ranks=ranks,
                                     use_sign=True,
                                     subspace_iters=subspace_iters)
        dWs2 = tuple(a - b for a, b in zip(Ws2, W_prev))
        ratios = factor_norm_ratios(list(Ws2), list(dWs2))
        quiet = jnp.all(jnp.abs(ratios) < tol_init)
        it2 = it + 1
        cn = jnp.linalg.norm(core2.ravel())
        dn2 = jnp.abs(cn - cn_prev)
        diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
        hist2 = write_hist(hist, it2, dn2, diffV, 0.0)
        snaps2, labels2, n2 = maybe_snap(it2, Ws2, snaps, snap_labels,
                                         snap_n)
        stop2 = (dn2 < diff_tol) | (it2 > maxiter)
        phase2 = jnp.where(quiet & ~stop2, 1, 0)
        return (it2, phase2, age, tuple(Ws2), tuple(Ws2), dWs2, W_init,
                single, pair_t, cn, dn2, core2, stop2, hist2, snaps2,
                labels2, n2, tol_init)

    def build_branch(st):
        (it, phase, age, Ws, W_prev, dWs, W_init, single, pair_t, cn_prev,
         dn, core, stop, hist, snaps, snap_labels, snap_n, tol_init) = st
        s_d, p_d = contract.build_ttmc_caches(V, list(Ws))
        if single_specs is not None:
            # -mesh runs: pin the planned TTMc cache shardings inside
            # the fused machine (VERDICT r3 weak #6 Tucker analogue)
            from jax.lax import with_sharding_constraint
            s_d = {i: with_sharding_constraint(x, single_specs[i])
                   for i, x in s_d.items()}
            p_d = {k: with_sharding_constraint(p_d[k], s)
                   for k, s in zip(keys, pair_specs)}
        single2 = tuple(s_d[i] for i in range(order))
        pair2 = tuple(p_d[k] for k in keys)
        zeros = tuple(jnp.zeros_like(W) for W in Ws)
        return (it, jnp.asarray(2), jnp.asarray(0), Ws, W_prev, zeros,
                tuple(Ws), single2, pair2, cn_prev, dn, core, stop, hist,
                snaps, snap_labels, snap_n, tol_init)

    def pp_branch(st):
        (it, phase, age, Ws, W_prev, dWs, W_init, single, pair_t, cn_prev,
         dn, core, stop, hist, snaps, snap_labels, snap_n, tol_init) = st
        p_d = {k: p for k, p in zip(keys, pair_t)}
        Ws2, dWs2, core2, stat2 = tucker_pp_sweep(
            single, p_d, list(Ws), list(W_init), list(dWs),
            quiet_frac * tol_init, age, ranks=ranks,
            subspace_iters=subspace_iters)
        ratios = factor_norm_ratios(list(Ws2), list(dWs2))
        broke = jnp.any(jnp.abs(ratios) > tol_init) | stat2
        age2 = age + 1
        it2 = it + 1
        cn = jnp.linalg.norm(core2.ravel())
        dn2 = jnp.abs(cn - cn_prev)
        diffV = jnp.sqrt(jnp.maximum(V_norm_sq - cn * cn, 0.0))
        hist2 = write_hist(hist, it2, dn2, diffV, 1.0)
        snaps2, labels2, n2 = maybe_snap(it2, Ws2, snaps, snap_labels,
                                         snap_n)
        stop2 = (dn2 < diff_tol) | (it2 > maxiter)
        to_dt = broke | (age2 >= pp_cap)
        phase2 = jnp.where(to_dt, 0, 2)
        W_prev2 = tuple(jnp.where(to_dt, jnp.zeros_like(w), wp)
                        for w, wp in zip(Ws2, W_prev))
        # tol_init decay on PP->DT (als_Tucker.cxx:947-948)
        tol2 = jnp.where(to_dt & (tol_init > floor), tol_init * decay,
                         tol_init)
        return (it2, phase2, age2, tuple(Ws2), W_prev2, tuple(dWs2),
                W_init, single, pair_t, cn, dn2, core2, stop2, hist2,
                snaps2, labels2, n2, tol2)

    def body(c):
        k, st = c
        st2 = jax.lax.switch(st[1], [dt_branch, build_branch, pp_branch], st)
        return k + 1, st2

    def cond(c):
        k, st = c
        return (k < chunk) & jnp.logical_not(st[12])

    assert len(carry) == 18, len(carry)  # tucker_fused_init + (tol_init,)
    _, out = jax.lax.while_loop(cond, body, (jnp.asarray(0), carry))
    return out


def als_tucker_pp_fused(V, ranks, cfg: TuckerConfig,
                        plot: Optional[PlotFile] = None,
                        Ws: Optional[List] = None,
                        clock: Optional[SweepClock] = None,
                        chunk: int = 64) -> TuckerResult:
    """Fully-fused device-resident Tucker DT <-> PP solver: one dispatch
    per ``chunk`` sweeps (cf. cp.als_cp_pp_fused)."""
    from pairwise_perturbation_tpu.models.cp import _host_pull, warm_compile
    V = jnp.asarray(V)
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = contract.norm_sq(V)
    if Ws is None:
        core, Ws = tracing.timed("tucker.hosvd", hosvd, V, ranks)
    else:
        Ws = [jnp.asarray(W) for W in Ws]
        core = contract.ttmc(V, Ws, skip_mode=-1)
    clock = clock or SweepClock()
    dtype = Ws[0].dtype
    max_hist = cfg.maxiter + 2
    tol_init0 = jnp.asarray(cfg.pp_res_tol, dtype)
    diff_tol = jnp.asarray(cfg.tol, dtype)
    maxiter = jnp.asarray(cfg.maxiter)
    decay = jnp.asarray(cfg.tol_init_decay, dtype)
    floor = jnp.asarray(cfg.tol_init_floor, dtype)
    quiet_frac = jnp.asarray(cfg.pp_quiet_frac, dtype)
    # slots cover one chunk's logged rows only — drained + reset per
    # chunk (ADVICE r3 #1)
    n_slots = min((cfg.maxiter // max(cfg.resprint, 1)) + 4,
                  (chunk // max(cfg.resprint, 1)) + 4)
    single_specs = pair_specs = None
    if cfg.mesh_layout is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        lay = cfg.mesh_layout
        order = V.ndim

        def cache_spec(keep):
            # kept modes stay tensor-sized (inherit V's axis), contracted
            # modes are rank-sized (replicated)
            return P(*[lay.mode_axis.get(m) if m in keep else None
                       for m in range(order)])

        single_specs = tuple(NamedSharding(lay.mesh, cache_spec((i,)))
                             for i in range(order))
        pair_specs = tuple(NamedSharding(lay.mesh, cache_spec((i, j)))
                           for (i, j) in _tucker_pair_keys(order))
    statics = dict(ranks=ranks, subspace_iters=cfg.subspace_iters,
                   chunk=chunk, resprint=cfg.resprint, pp_cap=15,
                   max_hist=max_hist, n_slots=n_slots,
                   single_specs=single_specs, pair_specs=pair_specs)

    history: list = []
    with clock.exclude():
        # carry init does one exact TTMc (the iteration-0 core) — setup,
        # not sweep time
        carry = tucker_fused_init(V, Ws, ranks, max_hist, n_slots) \
            + (tol_init0,)
        jax.block_until_ready(carry[11])
    with clock.exclude():
        warm_carry = carry[:12] + (jnp.asarray(True),) + carry[13:]
        warm_compile(tucker_fused_chunk, V, warm_carry, tol_init0, diff_tol,
                     maxiter, decay, floor, quiet_frac, **statics)
        del warm_carry

    with clock.exclude():
        # iteration-0 diagnostics (excluded, like every logged row)
        cn0 = float(jnp.linalg.norm(np.asarray(core).ravel()))
        dv0 = float(np.sqrt(max(float(V_norm_sq) - cn0 * cn0, 0.0)))
    dn = float("inf")
    diffV = dv0
    if plot is not None:
        plot.row(V.shape[0], 0, dn, cfg.tol, 0, dv0, clock.dtime())
    history.append(dict(iter=0, diffnorm=dn, diffV=dv0,
                        dtime=clock.dtime(), pp=0))

    prev_it = 0
    cn_by_label: dict = {0: cn0}  # exact core norms (for exact dn rows)
    t_prev = clock.dtime()
    while True:
        carry = tucker_fused_chunk(V, carry, tol_init0, diff_tol, maxiter,
                                   decay, floor, quiet_frac, **statics)
        it_now = int(_host_pull(carry[0]))
        stop = bool(_host_pull(carry[12]))
        t_now = clock.dtime()
        if it_now > prev_it:
            rows_all = _host_pull(carry[13])
            # EXACT diffV for logged rows from the machine's factor
            # snapshots — computed here in the excluded window so the
            # timed chunk never pays the extra TTMc chain (cf.
            # cp.als_cp_pp_fused)
            exact: dict = {}
            with clock.exclude():
                snap_n = int(np.asarray(carry[16]))
                if snap_n > n_slots:
                    import warnings
                    warnings.warn(
                        f"fused snapshot ring overflow: {snap_n} logged "
                        f"rows > {n_slots} slots; {snap_n - n_slots} "
                        "rows fall back to in-loop estimates")
                if snap_n > 0:
                    labels_all = np.asarray(carry[15])
                    for slot in range(min(snap_n, len(labels_all))):
                        Ws_s = [s[slot] for s in carry[14]]
                        cn_s = float(jnp.linalg.norm(contract.ttmc(
                            V, Ws_s, skip_mode=-1).ravel()))
                        lab_s = int(labels_all[slot])
                        cn_by_label[lab_s] = cn_s
                        exact[lab_s] = float(
                            np.sqrt(max(float(V_norm_sq) - cn_s * cn_s,
                                        0.0)))
            if snap_n > 0:
                # ring drained — reset the count so the next chunk
                # reuses the slots (ADVICE r3 #1)
                carry = carry[:16] + (jnp.asarray(0),) + carry[17:]
            rows = rows_all[prev_it + 1:it_now + 1]
            for off, label in enumerate(range(prev_it + 1, it_now + 1)):
                frac = (off + 1) / (it_now - prev_it)
                dt_row = t_prev + (t_now - t_prev) * frac
                dn, diffV = float(rows[off, 0]), float(rows[off, 1])
                ppf = int(rows[off, 2] > 0.5)
                if label in exact:
                    diffV = exact[label]
                    # with consecutive labels logged (resprint == 1) the
                    # exact core-norm delta replaces the in-loop dn
                    # estimate too (ADVICE r3 #3)
                    if label - 1 in cn_by_label and label in cn_by_label:
                        dn = abs(cn_by_label[label]
                                 - cn_by_label[label - 1])
                if label % cfg.resprint == 0 or label == cfg.maxiter:
                    if plot is not None:
                        plot.row(V.shape[0], label, dn, cfg.tol, ppf, diffV,
                                 dt_row)
                    history.append(dict(iter=label, diffnorm=dn, diffV=diffV,
                                        dtime=dt_row, pp=ppf))
        if stop or it_now > cfg.maxiter or t_now > cfg.timelimit \
                or it_now == prev_it:
            prev_it = it_now
            break
        prev_it = it_now
        t_prev = t_now
    Ws_f = list(carry[3])
    core_f = carry[11]
    with clock.exclude():
        cn_f = float(jnp.linalg.norm(contract.ttmc(
            V, Ws_f, skip_mode=-1).ravel()))
        diffV = float(np.sqrt(max(float(V_norm_sq) - cn_f * cn_f, 0.0)))
    return TuckerResult(Ws_f, core_f, dn, diffV, prev_it, dn < cfg.tol,
                        history)
