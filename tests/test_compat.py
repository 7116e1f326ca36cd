"""Compatibility & invariance tests: visdom-schema CSV parsing, seeded-init
determinism (the subworld-trick equivalent), sharded Tucker equivalence,
and order-6 PP correctness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pairwise_perturbation_tpu import cli
from pairwise_perturbation_tpu.models import cp, tucker
from pairwise_perturbation_tpu.ops import contract
from pairwise_perturbation_tpu.parallel import mesh as pmesh


def test_csv_parses_like_visdom_server(tmp_path):
    """The reference dashboard reads the CSV with pandas and indexes the
    bracketed column names (visdom_pull_server.py:86-123). Replicate that
    access pattern on our output."""
    pd = pytest.importorskip("pandas")
    out = str(tmp_path / "o.csv")
    cli.main(["test_als", "-model", "CP", "-tensor", "r", "-pp", "0",
              "-dim", "3", "-size", "8", "-rank", "3", "-maxiter", "10",
              "-resprint", "2", "-filename", out, "-dtype", "float64",
              "-quiet"])
    df = pd.read_csv(out, sep=",")
    for col in ["[dim]", "[iter]", "[gradnorm]", "[tol]", "[pp_update]",
                "[diffV]", "[dtime]"]:
        assert col in df.columns
    assert len(df) >= 3
    assert df["[diffV]"].iloc[-1] <= df["[diffV]"].iloc[1]


def test_seeded_init_is_device_count_invariant():
    """init_factors must be identical regardless of how many devices exist —
    the JAX version of the reference's MPI_COMM_SELF subworld trick
    (run.cxx:292-322)."""
    shape, R = (6, 7, 8), 3
    a = cp.init_factors(shape, R, key=jax.random.PRNGKey(7),
                        dtype=jnp.float64)
    b = cp.init_factors(shape, R, key=jax.random.PRNGKey(7),
                        dtype=jnp.float64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # and placing them on a mesh does not change the values
    mesh = pmesh.make_mesh((8,), ("x",))
    layout = pmesh.plan_layout(shape, mesh)
    sharded = pmesh.shard_factors(a, layout)
    out = pmesh.unshard_factors(sharded, layout)
    for x, y in zip(out, a):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_sharded_tucker_sweep_matches_unsharded(rng):
    shape, ranks = (6, 9, 12, 5), (2, 3, 3, 2)
    V = rng.standard_normal(shape)
    core0, Ws0 = tucker.hosvd(jnp.asarray(V), ranks)
    mesh = pmesh.make_mesh((4, 2), ("x", "y"))
    layout = pmesh.plan_layout(shape, mesh)
    Vs = pmesh.shard_tensor(V, layout)
    Wss = pmesh.shard_factors(Ws0, layout)
    Ws_sh, core_sh = tucker.tucker_dt_sweep(Vs, Wss, Wss,
                                            ranks=tuple(ranks),
                                            use_sign=False)
    Ws_pl, core_pl = tucker.tucker_dt_sweep(jnp.asarray(V), Ws0, Ws0,
                                            ranks=tuple(ranks),
                                            use_sign=False)
    outs = pmesh.unshard_factors(Ws_sh, layout)
    for a, b in zip(outs, Ws_pl):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-7)
    np.testing.assert_allclose(np.asarray(core_sh), np.asarray(core_pl),
                               atol=1e-6)


def test_order6_pp_caches_and_sweep(rng):
    """Order-6 (the synthetic scaling suite dimension): 15 pair caches,
    first-order correction exactness."""
    shape = (4, 5, 4, 5, 4, 5)
    V = rng.standard_normal(shape)
    Ws = [rng.standard_normal((s, 2)) for s in shape]
    jV = jnp.asarray(V)
    jWs = [jnp.asarray(W) for W in Ws]
    single, pair = contract.build_pp_caches(jV, jWs)
    assert len(pair) == 15 and len(single) == 6
    j = 4
    dW = rng.standard_normal(Ws[j].shape)
    dWs = [jnp.zeros_like(W) for W in jWs]
    dWs[j] = jnp.asarray(dW)
    Ws_new = [W.copy() for W in Ws]
    Ws_new[j] = Ws[j] + dW
    for i in (0, 3, 5):
        if i == j:
            continue
        got = contract.pp_correct_mttkrp(single[i], pair, dWs, i)
        want = contract.mttkrp(jV, [jnp.asarray(W) for W in Ws_new], i)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-8)
