"""Second-generation optimizer framework: CPD + optimizer policy classes.

JAX re-design of the reference's refactored OO layer (``src/``):

- :class:`Decomposition`      <-> src/decomposition.h:8-36
- :class:`CPD`                <-> src/CP.h / src/CP.cxx (the ``als`` loop)
- :class:`CPSimpleOptimizer`  <-> src/optimizer/cp_simple_optimizer.{h,cxx}
- :class:`CPDTOptimizer`      <-> src/optimizer/cp_dt_optimizer.{h,cxx}
                                  (two-subtree dimension tree, 0.5 sweeps/step)
- :class:`CPMSDTOptimizer`    <-> src/optimizer/cp_msdt_optimizer.{h,cxx}
                                  (multi-sweep DT, (N-1)/N sweeps/step,
                                  arXiv:2010.12056)
- :class:`CPDTLROptimizer`    <-> src/optimizer/cp_dt_lr_optimizer.{h,cxx}
- :class:`CPMSDTLROptimizer`  <-> src/optimizer/cp_msdt_lr_optimizer.{h,cxx}

Each ``step()`` dispatches one jitted XLA computation per (left_index,
positions) signature — at most O(order) compiled variants reused across all
steps. Factor/state rotation stays in host Python.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pairwise_perturbation_tpu import config
from pairwise_perturbation_tpu.ops import contract, dimtree, solve
from pairwise_perturbation_tpu.utils.metrics import PlotFile, SweepClock


def rotation_indexes(left_index: int, order: int) -> Tuple[int, ...]:
    """indexes = [left+1 .. order-1, 0 .. left-1]
    (cp_msdt_optimizer.cxx:update_indexes)."""
    return tuple(list(range(left_index + 1, order)) + list(range(left_index)))


@partial(jax.jit, static_argnames=("left_index",))
def chain_top(V, W_left, *, left_index: int):
    """First-level contraction V x W[left_index], axes in indexes order + rank
    (mttkrp_map_init, cp_msdt_optimizer.cxx:111-144). ``V`` may be a
    COO SparseTensor (run.cxx:137-140 threads -issparse into the
    second-gen constructors too): the contraction is then one
    fused-index segment_sum (ops/sparse.ttm_dense) and the rest of the
    chain runs on the dense intermediate."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    order = V.ndim
    indexes = rotation_indexes(left_index, order)
    if isinstance(V, sp.SparseTensor):
        T = sp.ttm_dense(V, W_left, left_index, rank_last=True)
        # axes: remaining modes ascending + rank -> indexes order + rank
        ascending = [m for m in range(order) if m != left_index]
        perm = [ascending.index(m) for m in indexes] + [len(ascending)]
        return T.transpose(perm)
    sweep = dimtree.ChainTreeSweep(
        V, [W_left if i == left_index else None for i in range(order)],
        indexes, left_index)
    return sweep.top()


@partial(jax.jit, static_argnames=("left_index", "positions", "solver"))
def chain_step(V, top, Ws, lam, *, left_index: int,
               positions: Tuple[int, ...], solver: str = "chol"):
    """Process tree positions in order: per-position MTTKRP from the chain
    tree, S assembly, gradient, solve (CPDTOptimizer::step /
    CPMSDTOptimizer::step). Returns (Ws_new, grads_by_position)."""
    order = V.ndim
    indexes = rotation_indexes(left_index, order)
    sweep = dimtree.ChainTreeSweep(V, list(Ws), indexes, left_index, top=top)
    grads = []
    for pos in positions:
        M = sweep.mttkrp(pos)
        i = indexes[pos]
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam)
        grads.append(contract.gradsubprob(M, S, sweep.factors[i]))
        sweep.factors[i] = solve.solve(M, S, method=solver)
    return sweep.factors, grads


@partial(jax.jit, static_argnames=("left_index", "positions", "solver",
                                   "lr_pos", "update_rank", "randomsvd",
                                   "lr_from_old"))
def chain_step_lr(V, top, Ws, lam, old_W_lr, key, *, left_index: int,
                  positions: Tuple[int, ...], solver: str, lr_pos: int,
                  update_rank: int, randomsvd: bool, lr_from_old: bool):
    """Like :func:`chain_step` but the position ``lr_pos`` is solved as a
    rank-``update_rank`` *update*: (U, s, VT) of dW = M pinv(S) - A with
    A = old_W_lr (MSDT-LR) or the current factor (DT-LR), and
    W <- A + U s VT (cp_dt_lr_optimizer.cxx:202-215,
    cp_msdt_lr_optimizer.cxx:246-256).
    Returns (Ws_new, grads, (U, s, VT))."""
    order = V.ndim
    indexes = rotation_indexes(left_index, order)
    sweep = dimtree.ChainTreeSweep(V, list(Ws), indexes, left_index, top=top)
    grads = []
    lr_usv = None
    for pos in positions:
        M = sweep.mttkrp(pos)
        i = indexes[pos]
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam)
        grads.append(contract.gradsubprob(M, S, sweep.factors[i]))
        if pos == lr_pos:
            A = old_W_lr if lr_from_old else sweep.factors[i]
            U, s, VT = solve.rankR_update_cholesky(
                M, A, S, update_rank, random=randomsvd, key=key)
            sweep.factors[i] = A + jnp.matmul(
                U * s, VT, precision=config.default_precision())
            lr_usv = (U, s, VT)
        else:
            sweep.factors[i] = solve.solve(M, S, method=solver)
    return sweep.factors, grads, lr_usv


@partial(jax.jit, static_argnames=("left_index",))
def lr_update_cache(V, cache, U, s, VT, *, left_index: int):
    """cache += (V x_left (U s)) x VT — low-rank refresh of the cached
    first-level contraction (update_cached_tensor,
    cp_dt_lr_optimizer.cxx:128-158 / cp_msdt_lr_optimizer.cxx:112-157).
    O(s^N * update_rank) instead of O(s^N * R). Sparse V: the x_left
    contraction is one fused-index segment_sum over the nonzeros."""
    from pairwise_perturbation_tpu.ops import sparse as sp
    order = V.ndim
    Us = U * s
    indexes = rotation_indexes(left_index, order)
    if isinstance(V, sp.SparseTensor):
        T = sp.ttm_dense(V, Us, left_index, rank_last=True)
        ascending = [m for m in range(order) if m != left_index]
        perm = [ascending.index(m) for m in indexes] + [len(ascending)]
        T = T.transpose(perm)
    else:
        # contract V's left mode with Us -> axes: modes != left
        # (ascending) + Ru
        rem = tuple(range(order))
        T, rem2 = contract.contract_mode_kr(V, rem, False, Us, left_index)
        # reorder remaining axes to indexes order (cache layout) + Ru
        axes_current = list(rem2)
        perm = [axes_current.index(m) for m in indexes] \
            + [len(axes_current)]
        T = T.transpose(perm)
    # contract Ru with VT[Ru, R] -> rank axis
    upd = jnp.tensordot(T, VT, axes=([T.ndim - 1], [0]),
                        precision=config.default_precision())
    return cache + upd


@partial(jax.jit, static_argnames=("left_index", "positions", "solver",
                                   "lr_pos", "update_rank", "randomsvd",
                                   "lr_from_old"))
def chain_step_lr_fused(V, cache, U, s, VT, Ws, lam, old_W_lr, key, *,
                        left_index: int, positions: Tuple[int, ...],
                        solver: str, lr_pos: int, update_rank: int,
                        randomsvd: bool, lr_from_old: bool):
    """Low-rank cache refresh + LR chain step in ONE dispatch:
    top = cache + (V x_left U s) x VT, then :func:`chain_step_lr` on it.
    Fusing lets XLA stream the refreshed top into the first position's
    MTTKRP instead of writing it out and reading it back (the cached
    first-level top is up to ~1.1 GB on coil-100 — one saved HBM pass,
    cp_dt_lr_optimizer.cxx:128-158 semantics). Returns
    (top, Ws_new, grads, usv)."""
    top = lr_update_cache(V, cache, U, s, VT, left_index=left_index)
    Ws2, grads, usv = chain_step_lr(
        V, top, Ws, lam, old_W_lr, key, left_index=left_index,
        positions=positions, solver=solver, lr_pos=lr_pos,
        update_rank=update_rank, randomsvd=randomsvd,
        lr_from_old=lr_from_old)
    return top, Ws2, grads, usv


@partial(jax.jit, static_argnames=("start_left", "solver", "lefts"))
def msdt_cycle(V, Ws, lam, *, start_left: int = -1, solver: str = "chol",
               lefts: Optional[Tuple[int, ...]] = None):
    """One full MSDT rotation — ``order`` consecutive steps (= order-1
    sweeps) fused into a single XLA computation.

    Equivalent to ``order`` successive CPMSDTOptimizer.step() calls
    (cp_msdt_optimizer.cxx:173-208); after a full rotation ``left_index``
    returns to its starting value, so the cycle is a fixed-structure
    computation reusable every macro-step. This removes all intra-cycle
    host round-trips (the reference pays none because MPI ranks run the
    loop natively).

    ``lefts`` overrides the hold-out sequence (restricted rotations skip
    tiny modes whose first-level contraction leaves a huge intermediate —
    an extension of the reference; every step still updates order-1
    modes).
    """
    order = V.ndim
    Ws = list(Ws)
    if lefts is None:
        left = start_left
        lefts = []
        for _ in range(order):
            left = (left + order - 1) % order
            lefts.append(left)
    grads = None
    for left in lefts:
        top = chain_top(V, Ws[left], left_index=left)
        Ws, grads = chain_step(V, top, Ws, lam, left_index=left,
                               positions=tuple(range(order - 1)),
                               solver=solver)
    return Ws, grads


@jax.jit
def _gradnorm(grads):
    return jnp.sqrt(contract.sum_sq(grads))


# ---------------------------------------------------------------------------
# Decomposition / CPD
# ---------------------------------------------------------------------------


class Decomposition:
    """Base decomposition holding V, factor list, sizes/ranks
    (src/decomposition.h:8-36)."""

    def __init__(self, order: int, sizes, ranks):
        self.order = order
        self.sizes = [sizes] * order if np.isscalar(sizes) else list(sizes)
        self.ranks = [ranks] * order if np.isscalar(ranks) else list(ranks)
        self.V = None
        self.W: Optional[List] = None

    def init(self, V, W: Sequence):
        from pairwise_perturbation_tpu.ops import sparse as sp
        if not isinstance(V, sp.SparseTensor):
            V = jnp.asarray(V)
        assert V.ndim == self.order
        for i in range(self.order):
            assert V.shape[i] == self.sizes[i]
            assert W[i].shape == (self.sizes[i], self.ranks[i])
        self.V = V
        self.W = [jnp.asarray(w) for w in W]

    # aliases matching the reference API surface (decomposition.h)
    Init = init

    def print_V(self):
        print(np.asarray(self.V))

    def print_W(self, i: int):
        print(np.asarray(self.W[i]))


class CPOptimizer:
    """Base optimizer: holds V/W/lambda, provides update_S
    (cp_als_optimizer.{h,cxx})."""

    def __init__(self, order: int, rank: int):
        self.order = order
        self.rank = rank
        self.V = None
        self.W: Optional[List] = None
        self.lam = 0.0

    def configure(self, V, W: List, lam: float = 0.0):
        self.V = V
        self.W = W
        self.lam = lam
        self.grads = None

    def update_S(self, i: int):
        return contract.hadamard_gram(self.W, skip_mode=i, regul=self.lam)

    def step(self) -> float:
        raise NotImplementedError


class CPSimpleOptimizer(CPOptimizer):
    """One sweep of exact per-mode MTTKRPs (cp_simple_optimizer.cxx:step)."""

    def step(self) -> float:
        from pairwise_perturbation_tpu.ops import sparse as sp
        lam = jnp.asarray(self.lam, dtype=self.W[0].dtype)
        if isinstance(self.V, sp.SparseTensor):
            from pairwise_perturbation_tpu.models.sparse_cp import \
                sparse_simple_sweep
            self.W = sparse_simple_sweep(self.V, self.W, lam,
                                         solver="chol", normalize=False)
            self.grads = None
            return 1.0
        from pairwise_perturbation_tpu.models.cp import simple_sweep
        self.W, self.grads = simple_sweep(self.V, self.W, lam, solver="chol",
                                          normalize=False)
        return 1.0


class CPMSDTOptimizer(CPOptimizer):
    """Multi-sweep dimension tree: rotate left_index by -1 each step, update
    the other N-1 modes (cp_msdt_optimizer.cxx).

    Extension (opt-in, ``min_holdout_size > 0``): restrict the hold-out
    rotation to modes of size >= min_holdout_size. Holding out a tiny mode
    m pays a first-level intermediate of ~|V|*R/s_m elements (on skewed
    real tensors like coil-100's size-3 mode that is 3.3x |V| of HBM
    traffic); skipping it keeps every step's intermediate small. All modes
    are still updated every step (order-1 updates/step) — only the update
    *schedule* changes, so this deviates from cp_msdt_optimizer.cxx
    semantics and defaults off.
    """

    def __init__(self, order: int, rank: int, min_holdout_size: int = 0):
        super().__init__(order, rank)
        self.left_index = order  # first update_indexes -> order-1
        self.min_holdout_size = min_holdout_size
        self.holdouts: Optional[Tuple[int, ...]] = None

    def configure(self, V, W: List, lam: float = 0.0):
        super().configure(V, W, lam)
        eligible = tuple(m for m in range(self.order)
                         if V.shape[m] >= self.min_holdout_size)
        self.holdouts = eligible if eligible else tuple(range(self.order))

    def _next_left(self) -> int:
        self.left_index = self._peek_next_left()
        return self.left_index

    def _peek_next_left(self) -> int:
        """The next hold-out in the (possibly restricted) rotation,
        without committing it."""
        order = self.order
        if self.holdouts is None or len(self.holdouts) == order:
            return (self.left_index + order - 1) % order
        below = [m for m in self.holdouts if m < self.left_index]
        return max(below) if below else max(self.holdouts)

    def _cycle_lefts(self) -> Tuple[int, ...]:
        """The hold-out sequence of one full rotation from the current
        state (restores left_index; :meth:`step_cycle` commits it)."""
        saved = self.left_index
        lefts = tuple(self._next_left()
                      for _ in range(len(self.holdouts or range(self.order))))
        self.left_index = saved
        return lefts

    def step(self) -> float:
        order = self.order
        left = self._next_left()
        lam = jnp.asarray(self.lam, dtype=self.V.dtype)
        top = chain_top(self.V, self.W[left], left_index=left)
        positions = tuple(range(order - 1))
        self.W, self.grads = chain_step(self.V, top, self.W, lam,
                                        left_index=left,
                                        positions=positions, solver="chol")
        return (order - 1) / order

    def step_cycle(self) -> float:
        """Device-resident full rotation in one dispatch (left_index is
        rotation-invariant over a full cycle)."""
        order = self.order
        lam = jnp.asarray(self.lam, dtype=self.V.dtype)
        lefts = self._cycle_lefts()
        self.W, self.grads = msdt_cycle(self.V, self.W, lam, lefts=lefts,
                                        solver="chol")
        self.left_index = lefts[-1]
        return len(lefts) * (order - 1) / order


class CPDTOptimizer(CPOptimizer):
    """Two-subtree dimension tree: alternates a first subtree updating
    modes at positions special_index..N-2 of indexes1 and a second subtree
    updating positions 0..special_index of indexes2; each step = 0.5 sweeps
    (cp_dt_optimizer.cxx)."""

    def __init__(self, order: int, rank: int):
        super().__init__(order, rank)
        self.left_index1 = order - 1
        self.left_index2 = (self.left_index1 + order - 1) % order
        self.special_index = 0
        self.first_subtree = True

    def _positions(self) -> Tuple[int, ...]:
        n = self.order - 1
        if self.first_subtree:
            return tuple(range(self.special_index, n))
        return tuple(range(0, self.special_index + 1))

    def step(self) -> float:
        left = self.left_index1 if self.first_subtree else self.left_index2
        lam = jnp.asarray(self.lam, dtype=self.V.dtype)
        top = chain_top(self.V, self.W[left], left_index=left)
        self.W, self.grads = chain_step(self.V, top, self.W, lam,
                                        left_index=left,
                                        positions=self._positions(),
                                        solver="chol")
        self.first_subtree = not self.first_subtree
        return 0.5


class CPDTLROptimizer(CPDTOptimizer):
    """DT + low-rank update of the cached first-level contraction
    (cp_dt_lr_optimizer.cxx). After warm-up, the big V x W contraction is
    replaced by cache += V x_left (U s VT) with (U, s, VT) the rank-r
    factorization of the last factor update."""

    def __init__(self, order: int, rank: int, update_rank: int,
                 randomsvd: bool = False, num_subiteration: int = 5,
                 seed: int = 0):
        super().__init__(order, rank)
        self.update_rank = update_rank
        self.randomsvd = randomsvd
        self.num_subiteration = num_subiteration
        self.count_subiteration = 0
        self.low_rank_decomp = False
        self.cached = {True: None, False: None}   # per-subtree caches
        self.usv = None
        self._key = jax.random.PRNGKey(seed)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def step(self) -> float:
        order = self.order
        left = self.left_index1 if self.first_subtree else self.left_index2
        lam = jnp.asarray(self.lam, dtype=self.V.dtype)
        positions = self._positions()
        do_lr = self.count_subiteration >= 1
        lr_pos = (positions[-1] if self.first_subtree else positions[0]) \
            if do_lr else -1
        refresh = self.low_rank_decomp and self.count_subiteration > 1
        indexes = rotation_indexes(left, order)
        if refresh:
            # refresh (a refresh step is always also an LR step:
            # count > 1 implies do_lr) fused with the chain step — one
            # dispatch, one HBM pass over the refreshed top
            U, s, VT = self.usv
            top, self.W, self.grads, usv = chain_step_lr_fused(
                self.V, self.cached[self.first_subtree], U, s, VT,
                self.W, lam, self.W[indexes[lr_pos]], self._next_key(),
                left_index=left, positions=positions, solver="chol",
                lr_pos=lr_pos, update_rank=self.update_rank,
                randomsvd=self.randomsvd, lr_from_old=False)
            self.cached[self.first_subtree] = top
            self.usv = usv
            self.low_rank_decomp = True
        elif do_lr:
            top = chain_top(self.V, self.W[left], left_index=left)
            self.cached[self.first_subtree] = top
            self.W, self.grads, usv = chain_step_lr(
                self.V, top, self.W, lam, self.W[indexes[lr_pos]],
                self._next_key(), left_index=left, positions=positions,
                solver="chol", lr_pos=lr_pos, update_rank=self.update_rank,
                randomsvd=self.randomsvd, lr_from_old=False)
            self.usv = usv
            self.low_rank_decomp = True
        else:
            top = chain_top(self.V, self.W[left], left_index=left)
            self.cached[self.first_subtree] = top
            self.W, self.grads = chain_step(self.V, top, self.W, lam,
                                            left_index=left,
                                            positions=positions,
                                            solver="chol")
        if not self.first_subtree:
            self.count_subiteration += 1
        if (self.count_subiteration == self.num_subiteration
                and not self.first_subtree):
            # rotate special_index, reset LR state (cp_dt_lr_optimizer.cxx:219-232)
            self.special_index = (self.special_index + 1) % (order - 1)
            self.count_subiteration = 0
            self.low_rank_decomp = False
            if self.special_index != 0:
                self.left_index1 = (self.left_index1 + order - 1) % order
                self.left_index2 = (self.left_index2 + order - 1) % order
            else:
                self.left_index1 = order - 1
                self.left_index2 = (self.left_index1 + order - 1) % order
        self.first_subtree = not self.first_subtree
        return 0.5


class CPMSDTLROptimizer(CPMSDTOptimizer):
    """MSDT + per-mode cached first contractions with low-rank refresh
    (cp_msdt_lr_optimizer.cxx)."""

    def __init__(self, order: int, rank: int, update_rank: int,
                 randomsvd: bool = False, seed: int = 0,
                 min_holdout_size: int = 0):
        super().__init__(order, rank, min_holdout_size=min_holdout_size)
        self.update_rank = update_rank
        self.randomsvd = randomsvd
        self.low_rank_decomp = False
        self.is_cached = [False] * order
        self.cached_tensors: List = [None] * order
        self.old_W: List = [None] * order
        self.usv = None
        self._key = jax.random.PRNGKey(seed)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def step(self) -> float:
        order = self.order
        left = self._next_left()
        lam = jnp.asarray(self.lam, dtype=self.V.dtype)
        positions = tuple(range(order - 1))
        indexes = rotation_indexes(left, order)
        # The low-rank update must target the NEXT hold-out: the usv
        # produced here is applied to that mode's cached chain-top at the
        # start of the next step (lr_update_cache), so they must refer to
        # the same mode. In the reference's full rotation the next
        # hold-out is always indexes[positions[-1]]
        # (cp_msdt_lr_optimizer.cxx:246-256); under the restricted
        # rotation (min_holdout_size) it can be any position — computing
        # the update at positions[-1] regardless left a stale usv of a
        # DIFFERENT mode to be applied to the next cache (shape blowup on
        # skewed tensors).
        lr_mode = self._peek_next_left()
        do_lr = lr_mode in indexes and self.is_cached[lr_mode]
        refresh = self.low_rank_decomp and self.is_cached[left]
        if refresh and do_lr:
            # refresh + LR step in one dispatch (chain_step_lr_fused)
            U, s, VT = self.usv
            top, self.W, self.grads, usv = chain_step_lr_fused(
                self.V, self.cached_tensors[left], U, s, VT, self.W, lam,
                self.old_W[lr_mode], self._next_key(), left_index=left,
                positions=positions, solver="chol",
                lr_pos=indexes.index(lr_mode),
                update_rank=self.update_rank, randomsvd=self.randomsvd,
                lr_from_old=True)
            self.cached_tensors[left] = top
            self.old_W[left] = self.W[left]
            self.usv = usv
            self.low_rank_decomp = True
            return (order - 1) / order
        if refresh:
            U, s, VT = self.usv
            top = lr_update_cache(self.V, self.cached_tensors[left],
                                  U, s, VT, left_index=left)
            self.cached_tensors[left] = top
            self.old_W[left] = self.W[left]
        else:
            top = chain_top(self.V, self.W[left], left_index=left)
            self.cached_tensors[left] = top
            self.old_W[left] = self.W[left]
            self.is_cached[left] = True
        if do_lr:
            self.W, self.grads, usv = chain_step_lr(
                self.V, top, self.W, lam, self.old_W[lr_mode],
                self._next_key(), left_index=left, positions=positions,
                solver="chol", lr_pos=indexes.index(lr_mode),
                update_rank=self.update_rank, randomsvd=self.randomsvd,
                lr_from_old=True)
            self.usv = usv
            self.low_rank_decomp = True
        else:
            self.W, self.grads = chain_step(self.V, top, self.W, lam,
                                            left_index=left,
                                            positions=positions,
                                            solver="chol")
            self.usv = None
            self.low_rank_decomp = False
        return (order - 1) / order


class CPD(Decomposition):
    """CP decomposition driver templated on an optimizer policy
    (src/CP.cxx:111-187)."""

    def __init__(self, order: int, sizes, rank, optimizer: CPOptimizer):
        ranks = rank
        super().__init__(order, sizes, ranks)
        self.optimizer = optimizer
        self.gradnorm = float("inf")

    def init(self, V, W: Sequence, lam: float = 0.0):
        super().init(V, W)
        self.optimizer.configure(self.V, self.W, lam)

    Init = init

    def als(self, tol: float, timelimit: float, maxsweep: int,
            resprint: int, plot: Optional[PlotFile] = None,
            bench: bool = False, macro: bool = False):
        """ALS driver loop (src/CP.cxx:111-187). With ``macro`` and an
        optimizer that exposes ``step_cycle`` (MSDT), each dispatch runs a
        full device-resident rotation instead of one step."""
        from pairwise_perturbation_tpu.ops import sparse as sp
        V = self.V
        is_sparse = isinstance(V, sp.SparseTensor)
        V_norm_sq = sp.norm_sq(V) if is_sparse else contract.norm_sq(V)
        clock = SweepClock()
        iters = 0
        sweeps = 0.0
        diffV = float("inf")
        history = []
        compile_excludes_left = 3 * self.order
        from pairwise_perturbation_tpu.models.cp import cp_diagnostics
        while int(sweeps) <= maxsweep:
            if iters % resprint == 0 or sweeps >= maxsweep or sweeps == 0:
                # sync queued steps BEFORE the excluded window (models/cp.py)
                jax.block_until_ready(self.optimizer.W)
                with clock.exclude():
                    W = self.optimizer.W
                    lam_d = jnp.asarray(self.optimizer.lam,
                                        dtype=W[0].dtype)
                    if is_sparse:
                        from pairwise_perturbation_tpu.models.sparse_cp \
                            import sparse_diagnostics
                        gn, dV = sparse_diagnostics(V_norm_sq, V, W, lam_d)
                    else:
                        gn, dV = cp_diagnostics(V_norm_sq, V, W, lam_d)
                    self.gradnorm, diffV = float(gn), float(dV)
                dtime = clock.dtime()
                if plot is not None:
                    plot.row(V.shape[0], sweeps, self.gradnorm, tol, 0, diffV,
                             dtime)
                history.append(dict(sweeps=sweeps, gradnorm=self.gradnorm,
                                    diffV=diffV, dtime=dtime))
                if self.gradnorm < tol or dtime > timelimit:
                    break
            from pairwise_perturbation_tpu.utils import tracing
            name = type(self.optimizer).__name__
            macro_step = macro and hasattr(self.optimizer, "step_cycle")
            fn = self.optimizer.step_cycle if macro_step \
                else self.optimizer.step
            if tracing.enabled():
                with tracing.timer(f"{name}.{'step_cycle' if macro_step else 'step'}"):
                    ds = fn()
                    jax.block_until_ready(self.optimizer.W)
                sweeps += ds
            else:
                # Rotating-tree optimizers (MSDT family) lazily compile a
                # distinct jit key per hold-out position, so compiles can
                # strike mid-run. Dispatch is async: synchronous host
                # time beyond 50 ms on a step is trace/compile — exclude
                # it from dtime (the reference pays no compile). The
                # exclusion is CAPPED at ~3 compiles per mode: once the
                # jit caches are hot, a long host block means the
                # dispatch queue is full of real device work and MUST be
                # counted (misclassifying it would undercount dtime, the
                # round-2 bug in the other direction).
                import time as _time
                t0 = _time.perf_counter()
                sweeps += fn()
                el = _time.perf_counter() - t0
                budget = compile_excludes_left
                if el > 0.05 and budget > 0:
                    clock.st_time += el
                    compile_excludes_left -= 1
            self.W = self.optimizer.W
            iters += 1
        self.history = history
        return self.gradnorm < tol
