"""What the GPU build runs, checked on the CPU: kernel routing by platform,
the order-3 MTTKRP (plain XLA chain and the Triton-route kernel in
interpret mode) against a numpy float64 oracle, f32 matmul precision, the
sparse gather/scatter choice, the compile-cache location, the native
library build and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pairwise_perturbation_tpu import native
from pairwise_perturbation_tpu.models import cp, optimizers, sparse_cp, tucker
from pairwise_perturbation_tpu.ops import contract
from pairwise_perturbation_tpu.ops import sparse as spo
from pairwise_perturbation_tpu.ops.kernels import mttkrp3_triton
from pairwise_perturbation_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eqns(jaxpr):
    """Every equation of a jaxpr, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _pallas_backends(fn, *args):
    return [e.params["backend"] for e in _eqns(jax.make_jaxpr(fn)(*args)
                                               .jaxpr)
            if e.primitive.name == "pallas_call"]


@pytest.fixture
def on(monkeypatch):
    """Pretend to run on the given platform. Jit caches key on shapes, not
    on the platform, so traces made under the pretence are dropped before
    and after."""
    def set_platform(platform):
        jax.clear_caches()
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
    yield set_platform
    jax.clear_caches()


def _problem(order, v_dtype, R=3):
    shape = (6, 5, 4, 3)[:order]
    V = jax.ShapeDtypeStruct(shape, v_dtype)
    Ws = [jax.ShapeDtypeStruct((s, R), jnp.float32) for s in shape]
    return V, Ws


ENTRY_POINTS = {
    "mttkrp": lambda V, Ws: contract.mttkrp(V, Ws, 0),
    "cp_gradnorm": lambda V, Ws: contract.cp_gradnorm(V, Ws),
    "cp_diagnostics": lambda V, Ws: cp.cp_diagnostics(
        jnp.float32(1.0), V, Ws),
    "build_pp_caches": lambda V, Ws: contract.build_pp_caches(V, Ws),
    "first_contraction": lambda V, Ws: contract.first_contraction(
        V, None, Ws[1], 1)[0],
}


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("v_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_kernel_routing(on, platform, v_dtype, order, entry):
    """Only order-3 f32 MTTKRPs on a GPU reach a pallas_call, and every
    pallas_call names the Triton route. cp_diagnostics upcasts a bf16 V
    to the factors' f32 before its MTTKRPs."""
    on(platform)
    V, Ws = _problem(order, v_dtype)
    backends = _pallas_backends(ENTRY_POINTS[entry], V, Ws)
    f32_v = v_dtype == jnp.float32 or entry == "cp_diagnostics"
    expect = (platform == "gpu" and order == 3 and f32_v
              and entry in ("mttkrp", "cp_gradnorm", "cp_diagnostics"))
    assert bool(backends) == expect, backends
    assert all(b == "triton" for b in backends), backends


def _mesh(n):
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


def _placed(n, spec):
    """An order-3 f32 V and factors on a mesh of ``n`` of the process's
    (eight virtual) devices, V sharded by ``spec``."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = _mesh(n)
    V = jax.device_put(np.ones((8, 5, 4), np.float32),
                       NamedSharding(mesh, P(*spec)))
    Ws = [jax.device_put(np.ones((s, 3), np.float32),
                         NamedSharding(mesh, P())) for s in (8, 5, 4)]
    return V, Ws


def _jit_pallas_backends(fn, *args):
    return [e.params["backend"] for e in _eqns(jax.jit(fn).trace(*args)
                                               .jaxpr.jaxpr)
            if e.primitive.name == "pallas_call"]


def test_kernel_off_with_several_devices(on):
    """V sharded over several devices: a pallas_call cannot be GSPMD-
    partitioned, so every entry point takes the XLA chain."""
    on("gpu")
    V, Ws = _placed(4, ("x",))
    for entry in ("mttkrp", "cp_gradnorm", "cp_diagnostics"):
        assert not _jit_pallas_backends(ENTRY_POINTS[entry], V, Ws), entry


# where V lies: None = a plain one-device array, else (mesh size, spec)
V_LAYOUTS = {"one_device": None, "one_device_mesh": (1, ("x",)),
             "replicated_on_mesh": (4, ())}


@pytest.mark.parametrize("where", sorted(V_LAYOUTS))
def test_kernel_follows_v_layout_not_device_count(on, where):
    """The process sees eight devices. A V on one device runs the kernel;
    a V laid over several devices does not, even when replicated."""
    on("gpu")
    if V_LAYOUTS[where] is None:
        V = jnp.ones((8, 5, 4), jnp.float32)
        Ws = [jnp.ones((s, 3), jnp.float32) for s in (8, 5, 4)]
    else:
        V, Ws = _placed(*V_LAYOUTS[where])
    on_mesh = where == "replicated_on_mesh"
    assert contract.spans_devices(V) == on_mesh
    assert bool(_jit_pallas_backends(ENTRY_POINTS["mttkrp"], V, Ws)) \
        == (not on_mesh)


def test_kernel_off_inside_shard_map(on):
    """sharded_mttkrp's per-device blocks sit on a mesh of several
    devices too, so it runs the XLA chain."""
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    on("gpu")
    V, Ws = _placed(4, ("x",))
    layout = pmesh.plan_layout(V.shape, _mesh(4))
    for mode in range(3):
        assert not _jit_pallas_backends(
            lambda V, Ws: pmesh.sharded_mttkrp(V, Ws, mode, layout), V, Ws)


RAGGED = [(64, 64, 64), (13, 20, 17), (7, 130, 33), (200, 200, 200)]


def _np_mttkrp(V, Ws, mode):
    letters = "abc"
    others = [m for m in range(3) if m != mode]
    spec = (f"abc,{letters[others[0]]}z,{letters[others[1]]}z"
            f"->{letters[mode]}z")
    return np.einsum(spec, V, Ws[others[0]], Ws[others[1]], optimize=True)


def _ragged_problem(shape, R=10):
    rng = np.random.default_rng(sum(shape))
    V = rng.standard_normal(shape).astype(np.float32)
    Ws = [rng.standard_normal((s, R)).astype(np.float32) for s in shape]
    return V, Ws


def _relerr(got, ref):
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_mttkrp3_xla_matches_f64_oracle(shape, mode):
    V, Ws = _ragged_problem(shape)
    ref = _np_mttkrp(V.astype(np.float64), [W.astype(np.float64)
                                            for W in Ws], mode)
    got = contract.mttkrp_xla(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                              mode)
    assert _relerr(got, ref) < 1e-5


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("shape", RAGGED[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_mttkrp3_kernel_interpret_matches_f64_oracle(shape, mode):
    """The Triton-route kernel in interpret mode; small row and chunk
    tiles so ragged edges, several programs and several chunks occur."""
    V, Ws = _ragged_problem(shape)
    ref = _np_mttkrp(V.astype(np.float64), [W.astype(np.float64)
                                            for W in Ws], mode)
    got = mttkrp3_triton.mttkrp3(jnp.asarray(V),
                                 [jnp.asarray(W) for W in Ws], mode,
                                 block_rows=32, block_k=16, chunk_rows=128,
                                 interpret=True)
    assert got.shape == ref.shape
    assert _relerr(got, ref) < 1e-5


def _f32_dots_below_highest(fn, *args):
    """dot_generals on f32 operands that could run in TF32 on a GPU."""
    bad = []
    for e in _eqns(jax.make_jaxpr(fn)(*args).jaxpr):
        if e.primitive.name != "dot_general":
            continue
        if any(v.aval.dtype == jnp.float32 for v in e.invars):
            prec = e.params["precision"]
            if prec is None or any(p != jax.lax.Precision.HIGHEST
                                   for p in prec):
                bad.append(str(e)[:120])
    return bad


def _f32(shape, R=3):
    V = jax.ShapeDtypeStruct(shape, jnp.float32)
    Ws = [jax.ShapeDtypeStruct((s, R), jnp.float32) for s in shape]
    return V, Ws


def _sparse_st(shape=(5, 4, 6), nnz=20):
    idx = jnp.zeros((nnz, len(shape)), jnp.int32)
    return spo.SparseTensor(idx, jnp.ones((nnz,), jnp.float32), shape)


F32_PATHS = {
    "dt_sweep": lambda: (lambda V, Ws: cp.dt_sweep(V, Ws, jnp.float32(0)),
                         *_f32((3, 5, 4, 6))),
    "simple_sweep": lambda: (lambda V, Ws: cp.simple_sweep(
        V, Ws, jnp.float32(0)), *_f32((5, 4, 6))),
    "pp_build_and_sweep": lambda: (lambda V, Ws: cp.pp_sweep(
        *cp.pp_build_caches(V, Ws), Ws, Ws, Ws, jnp.float32(0), 1.0),
        *_f32((3, 5, 4, 6))),
    "cp_diagnostics": lambda: (lambda V, Ws: cp.cp_diagnostics(
        jnp.float32(1.0), V, Ws), *_f32((3, 5, 4, 6))),
    "tucker_dt_sweep": lambda: (lambda V, Ws: tucker.tucker_dt_sweep(
        V, Ws, Ws, ranks=(3, 3, 3, 3), use_sign=True), *_f32((3, 5, 4, 6))),
    "msdt_cycle": lambda: (lambda V, Ws: optimizers.msdt_cycle(
        V, Ws, jnp.float32(0), start_left=3), *_f32((3, 5, 4, 6))),
    "sparse_sweep_and_diagnostics": lambda: (
        lambda Ws: (sparse_cp.sparse_simple_sweep(_sparse_st(), Ws,
                                                  jnp.float32(0)),
                    sparse_cp.sparse_diagnostics(jnp.float32(1.0),
                                                 _sparse_st(), Ws)),
        _f32((5, 4, 6))[1]),
}


@pytest.mark.parametrize("path", sorted(F32_PATHS))
def test_f32_main_path_matmuls_are_highest(path):
    """Every f32 matmul of the main path asks for Precision.HIGHEST: on an
    NVIDIA GPU a DEFAULT-precision f32 product may run in TF32."""
    fn, *args = F32_PATHS[path]()
    assert _f32_dots_below_highest(fn, *args) == []


SPARSE_ENTRIES = {
    "mttkrp": lambda st, Ws: spo.mttkrp(st, Ws, 0),
    "build_pp_caches": lambda st, Ws: spo.build_pp_caches(st, Ws),
}


@pytest.mark.parametrize("entry", sorted(SPARSE_ENTRIES))
@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_sparse_default_is_native_on_every_platform(on, platform, entry):
    """The sparse kernels gather natively and scatter with segment_sum
    (scatter-add) by default, whatever the platform: no one-hot matmul
    (an (nnz, s) dot) is traced."""
    on(platform)
    st = _sparse_st(shape=(9, 4, 6), nnz=20)
    Ws = [jax.ShapeDtypeStruct((s, 3), jnp.float32) for s in st.shape]
    eqns = list(_eqns(jax.make_jaxpr(SPARSE_ENTRIES[entry])(st, Ws).jaxpr))
    assert any(e.primitive.name == "scatter-add" for e in eqns)
    one_hot = [e for e in eqns if e.primitive.name == "dot_general"
               and any(v.aval.shape[:1] == (20,) for v in e.invars)]
    assert not one_hot, one_hot


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_native_builds_from_sources_and_detects_staleness(monkeypatch,
                                                          tmp_path):
    for src in native._sources():
        (tmp_path / os.path.basename(src)).write_bytes(
            open(src, "rb").read())
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    so = str(tmp_path / "libppnative.so")
    monkeypatch.setattr(native, "_SO_PATH", so)
    assert native._stale()
    assert native._build()
    assert os.path.exists(so) and not native._stale()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    later = os.path.getmtime(so) + 10
    os.utime(tmp_path / "planner.cpp", (later, later))
    assert native._stale()


def test_native_library_is_not_tracked():
    out = subprocess.run(["git", "ls-files", "native"], cwd=REPO,
                         capture_output=True, text=True)
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    assert not [p for p in out.stdout.split() if p.endswith(".so")]


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = _run_smoke(str(tmp_path), str(script))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
