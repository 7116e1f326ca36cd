"""Mode-order canonicalization for (8, 128)-tiled layouts.

A layout tiled (8, 128) over the last two dimensions pads the minor
dimension to a multiple of 128 and the second-minor to 8. A tensor whose
minor mode is small is then inflated — the reference's time-lapse
dataset (33, 1344, 1024, 9) (test_ALS.cxx:312-321) by 14x in its natural
order (9 -> 128) versus ~1x with the 1024-sized mode minor. CTF avoids
the issue by choosing its own cyclic layouts per tensor; here the
analogous runtime decision is a one-time mode permutation — CP/Tucker
ALS are mode-permutation-equivariant, so solvers run on the permuted
tensor and factors are mapped back at the end. It touches only shapes
with a small minor mode (the real-data path); whether the permutation
pays on a GPU, whose arrays are not tiled this way, is not measured yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _pad_waste(s_sub: int, s_lane: int) -> float:
    lane = -(-s_lane // 128) * 128 / s_lane
    sub = -(-s_sub // 8) * 8 / s_sub
    return lane * sub


def canonical_perm(shape: Sequence[int]) -> Tuple[int, ...]:
    """Mode permutation minimizing (8, 128) tile padding.

    Picks the (second-minor, minor) pair with the least padding waste —
    ties broken toward keeping the natural order — and orders the
    remaining (padding-irrelevant) modes ascending by size so the largest
    modes sit in the tiled positions.
    """
    order = len(shape)
    if order < 2:
        return tuple(range(order))
    best = None
    for lane in range(order):
        for sub in range(order):
            if sub == lane:
                continue
            waste = _pad_waste(shape[sub], shape[lane])
            # prefer natural order on ties
            tie = (lane != order - 1) + (sub != order - 2)
            key = (waste, tie, -shape[lane])
            if best is None or key < best[0]:
                rest = [m for m in range(order) if m not in (sub, lane)]
                best = (key, tuple(rest) + (sub, lane))
    return best[1]


def canonical_perm_or_identity(shape: Sequence[int],
                               threshold: float = 1.10) -> Tuple[int, ...]:
    """The permutation :func:`canonicalize` would apply for ``shape`` —
    decidable from the shape alone (used by the sharded loader to plan the
    production mode order before any byte is read)."""
    shape = tuple(int(s) for s in shape)
    ident = tuple(range(len(shape)))
    if len(shape) < 2:
        return ident
    natural = _pad_waste(shape[-2], shape[-1])
    perm = canonical_perm(shape)
    permuted = _pad_waste(shape[perm[-2]], shape[perm[-1]])
    if natural <= threshold or natural <= permuted * 1.02:
        return ident
    return perm


def canonicalize(V: np.ndarray, threshold: float = 1.10):
    """Permute V's modes for (8, 128) tiling when the natural layout wastes
    more than ``threshold`` in padding. Returns (V_perm, perm) with
    ``V_perm = transpose(V, perm)``; perm is the identity when the
    natural layout is already fine."""
    perm = canonical_perm_or_identity(V.shape, threshold)
    if perm == tuple(range(V.ndim)):
        return V, perm
    return np.ascontiguousarray(np.transpose(V, perm)), perm


def unpermute_factors(factors: Sequence, perm: Sequence[int]):
    """Map per-mode factor matrices of the permuted tensor back to the
    original mode order."""
    out = [None] * len(perm)
    for pos, m in enumerate(perm):
        out[m] = factors[pos]
    return out


def permute_tuple(values: Sequence, perm: Sequence[int]) -> tuple:
    """Reorder per-mode values (e.g. Tucker ranks) into permuted order."""
    return tuple(values[m] for m in perm)


def unpermute_core(core, perm: Sequence[int]):
    """Transpose a Tucker core computed in permuted mode order back to the
    original order (axis p of the permuted core is original mode perm[p]),
    so checkpoints stay internally consistent with unpermuted factors."""
    inv = np.argsort(np.asarray(perm))
    return np.transpose(np.asarray(core), inv)
