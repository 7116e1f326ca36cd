"""Second-gen optimizer framework tests (src/ equivalents)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pairwise_perturbation_tpu.models import cp, optimizers as opt
from pairwise_perturbation_tpu.ops import contract


def make_problem(rng, shape, R):
    Ws_true = [rng.random((s, R)) for s in shape]
    V = np.asarray(contract.build_dense([jnp.asarray(W) for W in Ws_true]))
    W0 = cp.init_factors(shape, R, dtype=jnp.float64)
    return jnp.asarray(V), W0


def run_cpd(V, W0, optimizer, maxsweep=60):
    order = V.ndim
    model = opt.CPD(order, list(V.shape), W0[0].shape[1], optimizer)
    model.init(V, [jnp.array(w) for w in W0], lam=0.0)
    model.als(tol=1e-12, timelimit=1e4, maxsweep=maxsweep, resprint=5)
    return model


@pytest.mark.parametrize("make_opt,sweep_frac", [
    (lambda order, R: opt.CPSimpleOptimizer(order, R), 1.0),
    (lambda order, R: opt.CPDTOptimizer(order, R), 0.5),
    (lambda order, R: opt.CPMSDTOptimizer(order, R), None),
])
def test_optimizer_step_accounting(rng, make_opt, sweep_frac):
    shape, R = (5, 6, 7, 8), 3
    V, W0 = make_problem(rng, shape, R)
    o = make_opt(len(shape), R)
    o.configure(V, [jnp.array(w) for w in W0], 0.0)
    got = o.step()
    want = sweep_frac if sweep_frac is not None else (len(shape) - 1) / len(shape)
    assert got == want


@pytest.mark.parametrize("make_opt", [
    lambda order, R: opt.CPSimpleOptimizer(order, R),
    lambda order, R: opt.CPDTOptimizer(order, R),
    lambda order, R: opt.CPMSDTOptimizer(order, R),
    lambda order, R: opt.CPDTLROptimizer(order, R, update_rank=2),
    lambda order, R: opt.CPMSDTLROptimizer(order, R, update_rank=2),
])
def test_cpd_converges(rng, make_opt):
    shape, R = (6, 6, 6, 6), 3
    V, W0 = make_problem(rng, shape, R)
    model = run_cpd(V, W0, make_opt(len(shape), R), maxsweep=80)
    Vn = float(jnp.linalg.norm(V.ravel()))
    final = model.history[-1]["diffV"]
    first = model.history[0]["diffV"]
    assert final < 0.05 * first, (first, final)


def test_msdt_equals_simple_after_full_rotation(rng):
    """MSDT updates N-1 modes per step with exact tree MTTKRPs; its
    trajectory must track the simple optimizer closely on a well-posed
    problem."""
    shape, R = (6, 6, 6, 6), 3
    V, W0 = make_problem(rng, shape, R)
    m1 = run_cpd(V, W0, opt.CPSimpleOptimizer(len(shape), R), maxsweep=40)
    m2 = run_cpd(V, W0, opt.CPMSDTOptimizer(len(shape), R), maxsweep=40)
    f1 = m1.history[-1]["diffV"]
    f2 = m2.history[-1]["diffV"]
    Vn = float(jnp.linalg.norm(V.ravel()))
    assert abs(f1 - f2) < 0.02 * Vn


def test_dt_optimizer_updates_all_modes(rng):
    shape, R = (5, 6, 7, 8), 3
    V, W0 = make_problem(rng, shape, R)
    o = opt.CPDTOptimizer(len(shape), R)
    o.configure(V, [jnp.array(w) for w in W0], 0.0)
    o.step()  # first subtree: modes 0..order-2
    o.step()  # second subtree: mode order-1
    for i, (a, b) in enumerate(zip(o.W, W0)):
        assert not np.allclose(np.asarray(a), np.asarray(b)), f"mode {i} unchanged"


def test_msdt_cycle_matches_steps(rng):
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import optimizers as opt

    shape, R = (6, 7, 8, 9), 4
    V = jnp.asarray(rng.standard_normal(shape))
    Ws0 = [jnp.asarray(rng.standard_normal((s, R))) for s in shape]

    a = opt.CPMSDTOptimizer(len(shape), R)
    a.configure(V, [w for w in Ws0], lam=0.0)
    for _ in range(len(shape)):
        a.step()

    b = opt.CPMSDTOptimizer(len(shape), R)
    b.configure(V, [w for w in Ws0], lam=0.0)
    sweeps = b.step_cycle()
    assert sweeps == len(shape) - 1
    for wa, wb in zip(a.W, b.W):
        np.testing.assert_allclose(np.asarray(wa), np.asarray(wb),
                                   rtol=1e-10, atol=1e-12)
    for ga, gb in zip(a.grads, b.grads):
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                                   rtol=1e-8, atol=1e-10)


def test_msdt_min_holdout_rotation_and_convergence(rng):
    """Restricted hold-out rotation (extension, opt-in): tiny modes are
    never held out, every step still updates order-1 modes, and the solver
    converges on a skewed exact-rank problem."""
    shape, R = (2, 8, 9, 10), 3
    V, W0 = make_problem(rng, shape, R)

    o = opt.CPMSDTOptimizer(len(shape), R, min_holdout_size=4)
    o.configure(V, [jnp.array(w) for w in W0], 0.0)
    assert o.holdouts == (1, 2, 3)
    lefts = [o._next_left() for _ in range(6)]
    assert lefts == [3, 2, 1, 3, 2, 1]  # descending cycle, mode 0 skipped
    assert o._cycle_lefts() == (3, 2, 1)

    model = run_cpd(V, W0, opt.CPMSDTOptimizer(len(shape), R,
                                               min_holdout_size=4),
                    maxsweep=60)
    first = model.history[0]["diffV"]
    final = model.history[-1]["diffV"]
    assert final < 0.05 * first, (first, final)


def test_msdt_min_holdout_cycle_matches_steps(rng):
    shape, R = (3, 7, 8, 9), 4
    V = jnp.asarray(rng.standard_normal(shape))
    Ws0 = [jnp.asarray(rng.standard_normal((s, R))) for s in shape]

    a = opt.CPMSDTOptimizer(len(shape), R, min_holdout_size=5)
    a.configure(V, [w for w in Ws0], lam=0.0)
    nsteps = len(a.holdouts)
    for _ in range(nsteps):
        a.step()

    b = opt.CPMSDTOptimizer(len(shape), R, min_holdout_size=5)
    b.configure(V, [w for w in Ws0], lam=0.0)
    sweeps = b.step_cycle()
    assert sweeps == nsteps * (len(shape) - 1) / len(shape)
    for wa, wb in zip(a.W, b.W):
        np.testing.assert_allclose(np.asarray(wa), np.asarray(wb),
                                   rtol=1e-10, atol=1e-12)


def test_msdt_min_holdout_all_too_small_falls_back(rng):
    shape, R = (4, 4, 4, 4), 2
    V, W0 = make_problem(rng, shape, R)
    o = opt.CPMSDTOptimizer(len(shape), R, min_holdout_size=100)
    o.configure(V, [jnp.array(w) for w in W0], 0.0)
    assert o.holdouts == (0, 1, 2, 3)  # fallback: full rotation
    assert o.step() == (len(shape) - 1) / len(shape)


def test_msdtlr_restricted_rotation_targets_next_holdout(rng):
    """MSDT-LR under the restricted hold-out rotation: the low-rank
    update must target the NEXT hold-out (whose cached chain-top it
    refreshes next step), not blindly the last rotation position —
    regression for the stale-usv shape blowup on skewed tensors
    (cp_msdt_lr_optimizer.cxx:246-256 semantics generalized)."""
    shape, R = (3, 8, 9, 16), 3
    Ws_true = [jnp.asarray(rng.random((s, R))) for s in shape]
    V = contract.build_dense(Ws_true)
    W0 = [jnp.asarray(rng.random((s, R))) for s in shape]
    Vn = float(jnp.linalg.norm(V.ravel()))
    o = opt.CPMSDTLROptimizer(len(shape), R, 1, False, min_holdout_size=8)
    o.configure(V, [jnp.array(w) for w in W0], 0.0)
    assert o.holdouts == (1, 2, 3)
    r0 = float(contract.cp_residual_exact(V, o.W)) / Vn
    for _ in range(3 * len(o.holdouts)):  # crosses every refresh path
        o.step()
    r1 = float(contract.cp_residual_exact(V, o.W)) / Vn
    assert np.isfinite(r1) and r1 < r0
