"""Regression tests for the round-1 "PP excursion" (a recorded trajectory
iter 30: diffV 34 -> 264 inside a PP phase).

Diagnosis (reproduced in f64 on the 64^4 rank-8 'r' config): the true
residual is MONOTONE through the PP phase; the jump was the device loop's
per-sweep diffV *estimate*, which used the exact-solve shortcut
||V||^2 - sum(S o G) — invalid during PP's damped, W_init-anchored solves
(als_CP.cxx:739-758) — and drifted upward with ||dW|| until the next
exact sweep snapped it back. The estimator now uses the norm identity
with the PP-corrected MTTKRP (cp._pp_sweep_norm_stats), first-order
accurate in dW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairwise_perturbation_tpu.models import cp
from pairwise_perturbation_tpu.ops import contract
from pairwise_perturbation_tpu.utils import synth


@pytest.fixture(scope="module")
def fixture64():
    # scaled-down version of the recorded excursion config (r, order 4,
    # rank 8) — f64 so norm-identity cancellation cannot mask anything
    V = synth.make_tensor("r", 4, 24, 8, dtype=np.float64)
    return jnp.asarray(V)


def test_pp_logged_rows_are_exact(fixture64):
    """With resprint set, the PP device phase snapshots logged rows'
    factors into the ring; the EXACT diagnostics the host computes from
    the final snapshot must equal the exact reconstruction residual of
    the returned factors to round-off (the snapshot-ring accounting that
    keeps diagnostics out of the timed dispatch, VERDICT r4 weak #6)."""
    V = fixture64
    Ws = cp.init_factors(V.shape, 8, dtype=jnp.float64)
    lam = jnp.asarray(0.0, dtype=V.dtype)
    for _ in range(10):
        Ws, _ = cp.dt_sweep(V, Ws, lam, solver="svd")
    n, Ws2, dWs, gn, hist, snaps, labels, snap_n = cp.pp_phase_device(
        V, Ws, lam, jnp.asarray(1.0), jnp.asarray(0.5), jnp.asarray(0.0),
        jnp.asarray(6), jnp.asarray(0), solver="svd", max_sweeps=15,
        resprint=1, n_slots=8)
    n = int(n)
    sn = int(snap_n)
    assert n >= 1 and sn == n  # resprint=1: every sweep snapshotted
    # the host-side exact diagnostics from the LAST snapshot...
    V_norm_sq = contract.norm_sq(V)
    Ws_s = [s[sn - 1] for s in snaps]
    _, dv = cp.cp_diagnostics(V_norm_sq, V, Ws_s, lam)
    # ...must match the exact residual of the returned factors
    exact = float(contract.cp_residual_exact(V, [w for w in Ws2]))
    assert abs(float(dv) - exact) / max(exact, 1e-12) < 1e-8, (dv, exact)
    # and the snapshot IS the returned iterate
    for a, b in zip(Ws_s, Ws2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pp_true_residual_bounded_before_restart(fixture64):
    """The solver invariant behind the excursion report: the TRUE residual
    must not grow materially within a PP phase before the restart
    tolerance fires."""
    V = fixture64
    Ws = cp.init_factors(V.shape, 8, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=1e-2, maxiter=40, resprint=1)
    res = cp.als_cp_pp(V, Ws, cfg)   # host driver: exact diagnostics
    hist = res.history
    assert any(h["pp"] for h in hist)
    prev = None
    for h in hist:
        if h["iter"] < 3:   # first sweeps from random init may wobble
            prev = h["diffV"]
            continue
        assert h["diffV"] <= prev * 1.05 + 1e-9, (h, prev)
        prev = h["diffV"]


def test_device_loop_history_has_no_excursion(fixture64):
    """End-to-end: the device phase machine's logged diffV (the quantity
    recorded in round 1's CSV) stays monotone-ish through PP phases."""
    V = fixture64
    Ws = cp.init_factors(V.shape, 8, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=1e-2, maxiter=40, resprint=1)
    res = cp.als_cp_pp_device(V, Ws, cfg)
    hist = [h for h in res.history if h["iter"] >= 3]
    assert any(h["pp"] for h in hist)
    for a, b in zip(hist, hist[1:]):
        assert b["diffV"] <= a["diffV"] * 1.10 + 1e-9, (a, b)
