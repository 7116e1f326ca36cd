"""f32 contractions on the card against the numpy float64 reference
(scripts/baseline_cpu.py) at real widths: the DT sweep and the PP sweep on
the coil-100 shape, the order-3 MTTKRP at 200^3 and the sparse MTTKRP on
the 200^4 fixture with 1.6M nonzeros. Tolerance 1e-4 relative Frobenius
error: Precision.HIGHEST is IEEE f32 (~1e-6 here); a TF32 product on this
zero-mean data errs ~5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import baseline_cpu as bl
from pairwise_perturbation_tpu.models import cp
from pairwise_perturbation_tpu.ops import contract
from pairwise_perturbation_tpu.ops import sparse as spo

pytestmark = pytest.mark.gpu

TOL = 1e-4
COIL = (3, 128, 128, 7200)
R = 10


def relerr(got, ref):
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _normal(key, shapes):
    keys = jax.random.split(jax.random.PRNGKey(key), len(shapes))
    return [jax.random.normal(k, s, jnp.float32) for k, s in zip(keys, shapes)]


@pytest.fixture(scope="module")
def coil():
    V, *Ws = _normal(1, [COIL] + [(s, R) for s in COIL])
    Vh = np.asarray(V, np.float64)
    Wh = [np.asarray(W, np.float64) for W in Ws]
    return V, Ws, Vh, Wh, contract.contraction_priority(COIL)


def test_dt_sweep_coil(coil):
    V, Ws, Vh, Wh, pr = coil
    Ws2, grads = cp.dt_sweep(V, Ws, jnp.asarray(0.0, jnp.float32))
    ref, ref_grads = bl.np_dt_sweep(Vh, Wh, pr)
    for i in range(len(COIL)):
        assert relerr(Ws2[i], ref[i]) < TOL
        assert relerr(grads[i], ref_grads[i]) < TOL


def test_pp_sweep_coil():
    """One PP sweep from the state PP runs in: factors near a CP solution
    of a rank-10 + 10% noise tensor, small dWs. Zero-mean factors keep S
    well conditioned, so the check measures the arithmetic, not an
    ill-conditioned solve's amplification. dW = W_solved - W_init
    is ~1% of W, so its error is measured against ||W|| (the f32
    cancellation of the difference is not an error of the sweep)."""
    F = _normal(6, [(s, R) for s in COIL])
    V = contract.build_dense(F)
    E = _normal(9, [COIL])[0]
    V = V + 0.1 * jnp.linalg.norm(V) / jnp.linalg.norm(E) * E
    Ws = [f * (1 + 0.01 * n) for f, n in zip(F, _normal(7, [f.shape
                                                            for f in F]))]
    dWs = [1e-3 * jnp.linalg.norm(W) / np.sqrt(W.size) * n
           for W, n in zip(Ws, _normal(8, [W.shape for W in Ws]))]
    cur = [W + d for W, d in zip(Ws, dWs)]
    single, pair = cp.pp_build_caches(V, Ws)
    got, got_dWs, _ = cp.pp_sweep(single, pair, cur, Ws, dWs,
                                  jnp.asarray(0.0, jnp.float32), 1.0)
    Wh = [np.asarray(W, np.float64) for W in Ws]
    s_ref, p_ref = bl.np_build_pp_caches(
        np.asarray(V, np.float64), Wh, contract.contraction_priority(COIL))
    ref, ref_dWs, _ = bl.np_pp_sweep(
        s_ref, p_ref, [np.asarray(W, np.float64) for W in cur], Wh,
        [np.asarray(d, np.float64) for d in dWs])
    for i in range(len(COIL)):
        assert relerr(got[i], ref[i]) < TOL
        err = np.linalg.norm(np.asarray(got_dWs[i], np.float64) - ref_dWs[i])
        assert err / np.linalg.norm(Wh[i]) < TOL


@pytest.mark.parametrize("impl", ["mttkrp", "mttkrp_xla"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_order3_mttkrp_200(mode, impl):
    """contract.mttkrp runs the Triton-route kernel on one GPU;
    contract.mttkrp_xla is the XLA chain."""
    V, *Ws = _normal(3, [(200, 200, 200)] + [(200, R)] * 3)
    ref = bl.np_mttkrp_chain(np.asarray(V, np.float64),
                             [np.asarray(W, np.float64) for W in Ws], mode,
                             (0, 1, 2))
    assert relerr(getattr(contract, impl)(V, Ws, mode), ref) < TOL


@pytest.mark.parametrize("method", ["onehot", "native"])
def test_sparse_mttkrp_fixture(method):
    shape, nnz = (200, 200, 200, 200), 1_600_000
    k = jax.random.split(jax.random.PRNGKey(4), len(shape) + 1)
    idx = jnp.stack([jax.random.randint(k[i], (nnz,), 0, s)
                     for i, s in enumerate(shape)], axis=1)
    vals = jax.random.uniform(k[-1], (nnz,), jnp.float32)
    st = spo.SparseTensor(idx.astype(jnp.int32), vals, shape)
    Ws = _normal(5, [(s, R) for s in shape])
    idx_h = np.asarray(idx)
    Wh = [np.asarray(W, np.float64) for W in Ws]
    for mode in range(len(shape)):
        prod = np.asarray(vals, np.float64)[:, None]
        for j in range(len(shape)):
            if j != mode:
                prod = prod * Wh[j][idx_h[:, j]]
        ref = np.stack([np.bincount(idx_h[:, mode], weights=prod[:, r],
                                    minlength=shape[mode])
                        for r in range(R)], axis=1)
        got = spo.mttkrp(st, Ws, mode, method=method)
        assert relerr(got, ref) < TOL
