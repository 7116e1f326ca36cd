"""Round-2 coverage: previously-untested public kit (VERDICT round 1,
"What's missing" #5), the threaded partupdate solver, loud
distributed_init, per-host sharded reads, and the Tucker auto extraction
path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairwise_perturbation_tpu.models import cp, tucker
from pairwise_perturbation_tpu.ops import contract, solve
from pairwise_perturbation_tpu.parallel import mesh as pmesh
from pairwise_perturbation_tpu.utils import io as ppio, synth


# ---------------------------------------------------------------------------
# solve.rankR_update_svd (common.cxx:788-813 semantics)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("random", [False, True])
def test_rankR_update_svd_factorizes_dw(rng, random):
    m, R = 24, 6
    M = jnp.asarray(rng.standard_normal((m, R)))
    A = jnp.asarray(rng.standard_normal((m, R)))
    G = rng.standard_normal((R, R))
    S = jnp.asarray(G @ G.T + R * np.eye(R))   # PSD, well conditioned
    dW_ref = np.asarray(M) @ np.linalg.pinv(np.asarray(S)) - np.asarray(A)
    for r in (2, R):
        U, s, VT = solve.rankR_update_svd(M, A, S, r, random=random)
        assert U.shape == (m, r) and s.shape == (r,) and VT.shape == (r, R)
        approx = np.asarray(U) * np.asarray(s) @ np.asarray(VT)
        # optimal rank-r truncation error of dW (Eckart-Young)
        sv = np.linalg.svd(dW_ref, compute_uv=False)
        opt = np.sqrt(np.sum(sv[r:] ** 2))
        err = np.linalg.norm(approx - dW_ref)
        # randomized range finder is near-optimal, not optimal
        slack = 1e-8 if not random else 0.35 * np.linalg.norm(dW_ref)
        assert err <= opt + slack + 1e-10


def test_rankR_update_svd_matches_cholesky_variant(rng):
    m, R, r = 16, 5, 3
    M = jnp.asarray(rng.standard_normal((m, R)))
    A = jnp.asarray(rng.standard_normal((m, R)))
    G = rng.standard_normal((R, R))
    S = jnp.asarray(G @ G.T + R * np.eye(R))
    Us, ss, VTs = solve.rankR_update_svd(M, A, S, r)
    Uc, sc, VTc = solve.rankR_update_cholesky(M, A, S, r)
    np.testing.assert_allclose(
        np.asarray(Us) * np.asarray(ss) @ np.asarray(VTs),
        np.asarray(Uc) * np.asarray(sc) @ np.asarray(VTc),
        rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# contract.khatri_rao / contract.cp_gradient
# ---------------------------------------------------------------------------


def test_khatri_rao_matches_outer_products(rng):
    shapes, R = (4, 5, 3), 6
    Ws = [jnp.asarray(rng.standard_normal((s, R))) for s in shapes]
    H = np.asarray(contract.khatri_rao(Ws))
    assert H.shape == shapes + (R,)
    for r in range(R):
        expect = np.multiply.outer(
            np.multiply.outer(np.asarray(Ws[0])[:, r],
                              np.asarray(Ws[1])[:, r]),
            np.asarray(Ws[2])[:, r])
        np.testing.assert_allclose(H[..., r], expect, rtol=1e-12)


def test_cp_gradient_matches_finite_differences(rng):
    shapes, R = (4, 3, 5), 3
    V = jnp.asarray(rng.standard_normal(shapes))
    Ws = [jnp.asarray(rng.standard_normal((s, R))) for s in shapes]
    grads = contract.cp_gradient(V, Ws)

    def f(Ws_):
        return 0.5 * float(jnp.sum(
            (V - contract.build_dense(Ws_)) ** 2))

    eps = 1e-6
    for i in (0, 2):
        for (a, b) in [(0, 0), (shapes[i] - 1, R - 1)]:
            Wp = [w.copy() for w in Ws]
            Wm = [w.copy() for w in Ws]
            Wp[i] = Wp[i].at[a, b].add(eps)
            Wm[i] = Wm[i].at[a, b].add(-eps)
            num = (f(Wp) - f(Wm)) / (2 * eps)
            assert abs(float(grads[i][a, b]) - num) < 1e-5


def test_cp_gradient_with_regularization(rng):
    shapes, R = (4, 4, 4), 3
    V = jnp.asarray(rng.standard_normal(shapes))
    Ws = [jnp.asarray(rng.standard_normal((s, R))) for s in shapes]
    lam = 0.7
    grads = contract.cp_gradient(V, Ws, regul=lam)
    # grad_i = -M_i + W_i (S_i + lam I)
    for i in range(3):
        M = contract.mttkrp(V, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        np.testing.assert_allclose(np.asarray(grads[i]),
                                   np.asarray(-M + Ws[i] @ S), rtol=1e-10)


# ---------------------------------------------------------------------------
# synth.identity_tensor / synth.build_from_vectors
# ---------------------------------------------------------------------------


def test_identity_tensor():
    s, N = 3, 4
    V = synth.identity_tensor(N, s)
    assert V.shape == (s,) * N
    for a in range(s):
        for b in range(s):
            for c in range(s):
                for d in range(s):
                    expect = float(a == b) * float(c == d)
                    assert V[a, b, c, d] == expect


def test_build_from_vectors(rng):
    vecs = [rng.standard_normal(s) for s in (3, 4, 2)]
    V = synth.build_from_vectors(vecs)
    expect = np.einsum("a,b,c->abc", *vecs)
    np.testing.assert_allclose(V, expect, rtol=1e-12)


# ---------------------------------------------------------------------------
# partupdate threads cfg.solver (models/cp.py round-1 hardcode)
# ---------------------------------------------------------------------------


def test_partupdate_respects_solver_choice(rng):
    V = jnp.asarray(synth.make_tensor("r", 3, 10, 4, dtype=np.float64))
    Ws = cp.init_factors(V.shape, 4, dtype=jnp.float64)
    for solver in ("chol", "svd"):
        cfg = cp.CPConfig(maxiter=20, resprint=5, solver=solver,
                          update_percentage=0.67, pp_res_tol=0.5)
        res = cp.als_cp_pp(V, Ws, cfg, partial_update=True)
        assert np.isfinite(res.diffV)
        assert res.diffV < 0.5 * float(jnp.linalg.norm(V.ravel()))


# ---------------------------------------------------------------------------
# distributed_init is loud
# ---------------------------------------------------------------------------


def test_distributed_init_single_host_noop():
    pmesh.distributed_init(single_host=True)
    pmesh.distributed_init()  # no coordinator configured -> no-op


def test_distributed_init_raises_on_failed_bringup(monkeypatch):
    def boom(**kwargs):
        raise RuntimeError("connection refused")
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="bring-up failed"):
        pmesh.distributed_init(coordinator_address="127.0.0.1:1")


def test_distributed_init_tolerates_already_initialized(monkeypatch):
    def already(**kwargs):
        raise RuntimeError("distributed is already initialized")
    monkeypatch.setattr(jax.distributed, "initialize", already)
    pmesh.distributed_init(coordinator_address="127.0.0.1:1")


# ---------------------------------------------------------------------------
# per-host sharded dataset read == monolithic load
# ---------------------------------------------------------------------------


def test_read_dense_sharded_matches_monolithic(tmp_path, rng):
    shape = (12, 6, 10)   # mode 0 not divisible by 8 -> padding exercised
    V = rng.standard_normal(shape)
    path = str(tmp_path / "t.bin")
    ppio.write_dense_binary(path, V)

    mesh = pmesh.make_mesh((8,))
    layout = pmesh.plan_layout(shape, mesh)
    Vs = ppio.read_dense_sharded(path, layout)
    assert Vs.shape == layout.padded_shape
    # monolithic path: full read, pad + shard
    V_mono = ppio.read_dense_binary(path, shape, out_dtype=np.float32)
    Vs_mono = pmesh.shard_tensor(V_mono, layout)
    np.testing.assert_allclose(np.asarray(Vs), np.asarray(Vs_mono),
                               rtol=1e-6)
    # unpadded content round-trips
    np.testing.assert_allclose(
        np.asarray(Vs)[tuple(slice(0, s) for s in shape)],
        V.astype(np.float32), rtol=1e-6)


def test_read_dense_sharded_2d_mesh(tmp_path, rng):
    shape = (9, 8, 5)
    V = rng.standard_normal(shape)
    path = str(tmp_path / "t2.bin")
    ppio.write_dense_binary(path, V)
    mesh = pmesh.make_mesh((4, 2))
    layout = pmesh.plan_layout(shape, mesh)
    Vs = ppio.read_dense_sharded(path, layout)
    np.testing.assert_allclose(
        np.asarray(Vs)[tuple(slice(0, s) for s in shape)],
        V.astype(np.float32), rtol=1e-6)


def test_ctf_ordered_load_semantics(tmp_path, rng):
    # CTF's global order is column-major: a row-major (I, J, K) file read
    # as the CTF-declared (K, J, I) tensor must satisfy V[c, b, a] ==
    # file[a, b, c] (round 1 read the bytes row-major in the declared
    # shape, scrambling real data).
    file_shape = (5, 4, 3)
    arr = rng.standard_normal(file_shape)
    path = str(tmp_path / "ctf.bin")
    ppio.write_dense_binary(path, arr)
    V = ppio._load_ctf_ordered(path, file_shape, np.float64)
    assert V.shape == (3, 4, 5)
    for a in range(5):
        for b in range(4):
            for c in range(3):
                assert V[c, b, a] == arr[a, b, c]


# ---------------------------------------------------------------------------
# Tucker auto extraction (subspace_iters == -1)
# ---------------------------------------------------------------------------


def test_resolve_subspace_iters():
    rs = tucker._resolve_subspace_iters
    assert rs(0, 10_000, 10) == 0          # explicit exact wins
    assert rs(3, 10_000, 10) == 3          # explicit count wins
    assert rs(-1, 300, 10) == tucker.AUTO_SUBSPACE_ITERS
    assert rs(-1, 100, 10) == 0            # small side -> exact
    assert rs(-1, 300, 200) == 0           # wide rank -> exact guard


def test_tucker_auto_matches_exact_fitness(rng):
    # mode 0 (size 300) has m = 20*20 = 400 >= s_i -> eigh side 300 >= the
    # AUTO threshold:
    # the auto path triggers for that mode only.
    shape, ranks = (300, 20, 20), (10, 8, 8)
    core = rng.standard_normal(ranks)
    Qs = [np.linalg.qr(rng.standard_normal((s, r)))[0]
          for s, r in zip(shape, ranks)]
    V = np.einsum("abc,ia,jb,kc->ijk", core, *Qs)
    V += 0.01 * np.linalg.norm(V) / np.sqrt(V.size) \
        * rng.standard_normal(shape)
    V = jnp.asarray(V, dtype=jnp.float32)

    res_auto = tucker.als_tucker(
        V, ranks, tucker.TuckerConfig(maxiter=8, subspace_iters=-1))
    res_exact = tucker.als_tucker(
        V, ranks, tucker.TuckerConfig(maxiter=8, subspace_iters=0))
    vn = float(jnp.linalg.norm(V.ravel()))
    assert abs(res_auto.diffV - res_exact.diffV) / vn < 1e-3
