"""Numerical-risk tests (SURVEY.md section 7 'hard parts'): f32 vs f64 on
the ill-conditioned collinearity fixture, and the auto solver fallback."""

import numpy as np
import jax.numpy as jnp
import pytest

from pairwise_perturbation_tpu.models import cp
from pairwise_perturbation_tpu.ops import solve
from pairwise_perturbation_tpu.utils import synth


def test_auto_solve_falls_back_on_singular():
    # singular PSD matrix
    S = jnp.asarray(np.diag([1.0, 1.0, 0.0]))
    W_true = np.array([[1.0, 2.0, 0.0], [3.0, 4.0, 0.0]])
    M = jnp.asarray(W_true @ np.asarray(S))
    W = solve.auto_solve(M, S)
    assert np.all(np.isfinite(np.asarray(W)))
    np.testing.assert_allclose(np.asarray(W)[:, :2], W_true[:, :2],
                               rtol=1e-6)


def test_auto_solve_uses_cholesky_when_spd(rng):
    A = rng.standard_normal((4, 4))
    S = jnp.asarray(A @ A.T + 4 * np.eye(4))
    W_true = rng.standard_normal((6, 4))
    M = jnp.asarray(W_true @ np.asarray(S))
    W = solve.auto_solve(M, S)
    np.testing.assert_allclose(np.asarray(W), W_true, rtol=1e-8)


def test_collinearity_f32_tracks_f64(rng):
    """The 'c' fixture makes S near-singular; the f32 path (the default)
    must track the f64 trajectory within loose tolerance."""
    V = synth.make_tensor("c", dim=4, s=8, R=3, seed=1, dtype=np.float64)
    Vn = np.linalg.norm(V)
    W0 = cp.init_factors(V.shape, 3, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, maxiter=40, resprint=10)
    res64 = cp.als_cp_dt(V, [jnp.asarray(w) for w in W0], cfg)
    res32 = cp.als_cp_dt(V.astype(np.float32),
                         [jnp.asarray(w, dtype=jnp.float32) for w in W0], cfg)
    rel64 = res64.diffV / Vn
    rel32 = res32.diffV / Vn
    assert abs(rel32 - rel64) < 0.02, (rel32, rel64)


def test_collinearity_pp_converges_f32(rng):
    V = synth.make_tensor("c", dim=4, s=8, R=3, seed=1, dtype=np.float32)
    Vn = np.linalg.norm(V)
    W0 = cp.init_factors(V.shape, 3, dtype=jnp.float32)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=60, resprint=10)
    res = cp.als_cp_pp(V, W0, cfg)
    assert res.diffV < 0.3 * Vn
    gns = [h["gradnorm"] for h in res.history if np.isfinite(h["gradnorm"])]
    assert gns[-1] < gns[0]


def test_mixed_bf16_mttkrp_accuracy(rng):
    """bf16-stored V with f32 accumulation: MTTKRP within bf16 tolerance
    of the f64 oracle (mixed-precision mode, contract._einsum)."""
    from pairwise_perturbation_tpu.ops import contract

    shape, R = (6, 7, 8), 4
    V = rng.standard_normal(shape)
    Ws = [jnp.asarray(rng.standard_normal((s, R))) for s in shape]
    want = np.asarray(contract.mttkrp(jnp.asarray(V), Ws, 0))
    got = contract.mttkrp(jnp.asarray(V, dtype=jnp.bfloat16),
                          [w.astype(jnp.float32) for w in Ws], 0)
    assert got.dtype == jnp.float32
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() < 3e-2 * scale


def test_mixed_bf16_dt_converges_like_f32(rng):
    """DT-ALS with bf16-stored V reaches a fitness plateau close to the
    f32 run on the collinearity fixture (the numerically nasty case)."""
    V = synth.make_tensor("c", dim=3, s=16, R=4, seed=2, dtype=np.float64)
    Vn = float(np.linalg.norm(V))
    W0 = cp.init_factors(V.shape, 4, dtype=jnp.float32)
    cfg = cp.CPConfig(tol=0.0, maxiter=40, resprint=40)
    res32 = cp.als_cp_dt(jnp.asarray(V, dtype=jnp.float32),
                         [jnp.asarray(w) for w in W0], cfg)
    res16 = cp.als_cp_dt(jnp.asarray(V, dtype=jnp.bfloat16),
                         [jnp.asarray(w) for w in W0], cfg)
    f32_fit = res32.diffV / Vn
    f16_fit = res16.diffV / Vn
    # both should have made real progress; bf16 plateau within a small
    # absolute offset of the f32 one (relative residual units)
    assert f16_fit < 0.5
    assert f16_fit - f32_fit < 0.05


def test_f32_pinv_floors_noise_eigenvalues():
    """Regression (VERDICT r3 weak #1): an f32 pseudo-inverse with the
    config's tiny f64-scale rcond must still floor at the dtype noise
    level — eigenvalues of order eps * lam_max are eigh noise and
    reciprocating them injects ~1/eps amplification into the solve."""
    rng = np.random.default_rng(5)
    R = 10
    # S with a genuine near-null space: eigenvalues down to 1e-9 * lam_max
    Q, _ = np.linalg.qr(rng.standard_normal((R, R)))
    lam = np.logspace(0, -9, R)
    S = (Q * lam) @ Q.T
    W_true = rng.standard_normal((50, R))
    M = W_true @ S
    W32 = solve.svd_solve(jnp.asarray(M, jnp.float32),
                          jnp.asarray(S, jnp.float32))
    # without the floor the noise directions blow |W| up by ~1e5; with it
    # the solve stays bounded by the true minimum-norm solution's scale
    W_ref = M @ np.linalg.pinv(S, rcond=1e-5)
    assert np.linalg.norm(np.asarray(W32)) < 10 * np.linalg.norm(W_ref)


def test_f32_solve_refinement_restores_backward_stability():
    """Low-precision solves get iterative refinement (ops/solve.py):
    the backward residual ||W S - M|| must land near f32 eps, not at
    cond(S) * eps."""
    rng = np.random.default_rng(7)
    R = 8
    base = rng.random((24, R))
    base = 0.003 * base + 0.997 * base[:, :1]  # nearly collinear columns
    S = (base.T @ base) ** 3                   # hadamard-of-grams style
    W_true = rng.random((24, R))
    M = W_true @ S
    S32, M32 = jnp.asarray(S, jnp.float32), jnp.asarray(M, jnp.float32)
    W_raw = solve.svd_solve(M32, S32, refine=0)
    W_ref = solve.svd_solve(M32, S32)  # default config refinement
    res_raw = np.linalg.norm(np.asarray(W_raw) @ S - M)
    res_ref = np.linalg.norm(np.asarray(W_ref) @ S - M)
    assert res_ref <= res_raw  # refinement never hurts
    assert res_ref < 1e-4 * np.linalg.norm(M)
    # cholesky path refines too
    W_chol = solve.cholesky_solve(M32, S32)
    assert np.linalg.norm(np.asarray(W_chol) @ S - M) \
        < 1e-4 * np.linalg.norm(M)


def test_f64_solves_skip_refinement_and_floor():
    """f64 behavior is unchanged: eps floor (2e-15) sits below the
    default rcond and refinement is skipped (reference parity —
    common.cxx:710-725 raw-reciprocal semantics modulo rcond)."""
    rng = np.random.default_rng(9)
    R = 6
    A = rng.standard_normal((R, R))
    S = jnp.asarray(A @ A.T + np.eye(R))
    W_true = rng.standard_normal((12, R))
    M = jnp.asarray(np.asarray(W_true) @ np.asarray(S))
    W = solve.svd_solve(M, S)
    np.testing.assert_allclose(np.asarray(W), W_true, rtol=1e-10)


def test_f32_pp_gradnorm_no_explosion(rng):
    """End-to-end regression for the round-3 late-run blow-up: a long
    f32 PP run on the ill-conditioned collinearity fixture must keep the
    EXACT logged gradnorm within a bounded envelope of its running
    minimum (the r3 CSVs showed 1000x+ sustained explosions) and end
    with a finite, decayed gradnorm."""
    V = synth.make_tensor("c", dim=4, s=24, R=8, col_min=0.9, col_max=0.99,
                          ratio_noise=0.01, seed=3, dtype=np.float32)
    Vn = float(np.linalg.norm(V))
    W0 = cp.init_factors(V.shape, 8, dtype=jnp.float32)
    cfg = cp.CPConfig(tol=1e-10 * Vn, pp_res_tol=0.1, maxiter=200,
                      resprint=10, solver="svd")
    res = cp.als_cp_pp(V, W0, cfg)
    gns = [h["gradnorm"] for h in res.history]
    assert all(np.isfinite(g) for g in gns)
    # late-run rows must not sit orders of magnitude above the best seen
    gmin = min(gns[1:])
    late = gns[len(gns) // 2:]
    assert max(late) < 1e3 * gmin, (max(late), gmin)
    # diffV must not regress by more than the oscillation envelope
    dvs = [h["diffV"] for h in res.history]
    assert dvs[-1] < 20 * min(dvs), (dvs[-1], min(dvs))
