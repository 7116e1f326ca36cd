#!/usr/bin/env python
"""Smoke test of the CP/Tucker ALS main path on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py           # phases A-D on one card
    python chip_smoke.py --four    # only the four-card -mesh path

It refuses to run anywhere but a GPU (no CPU fallback), runs everything in
this one process (CLI runs go through ``cli.main(argv)``), and prints as its
last line ``{"ok": true, "device": {...}}`` only when every phase passed.

Phases (one card):

A. ``jax.block_until_ready`` waits on the card: a ~1 s chain of dependent
   matmuls timed with it and with a host pull agrees.
B. Contractions against a plain float64 reference on the host (numpy, from
   the same device data pulled back; ``scripts/baseline_cpu.py`` and the
   COO helpers below): the coil-100 shape 3x128x128x7200 at rank 10 (every
   MTTKRP, ``cp.pp_build_caches``, one ``cp.dt_sweep``) in f32, bf16-V and
   f64; order 3 at 200^3 (every MTTKRP) with XLA's time at 200^3 and 512^3
   against a read-V-once roofline; the sparse 200^4 fixture with 1.6M
   nonzeros (MTTKRP and PP caches, one-hot and native gathers/scatters,
   both timed); ``eigh`` against two warm subspace iterations.
C. The main path end to end: ``cp.als_cp_dt`` / ``cp.als_cp_pp`` on the
   coil shape in f32 and f64, then the CLI on the reference's weak-scaling
   deployment at n = 1 (order 6, size 32, rank 4) and its Poisson
   deployment at n = 1 (order 8, size 13, rank 2, sparse).
D. ``pytest tests_gpu/``; any failure or skip fails the phase.

Tolerances (relative Frobenius error against the f64 reference):

- f32 at Precision.HIGHEST (IEEE f32, not TF32): 1e-4. HIGHEST errors are
  ~1e-6 here; a TF32 product (10-bit mantissa) on the zero-mean data used
  gives ~5e-4, so an unflagged matmul fails this bound.
- bf16-V: 5e-3. V and the factor of the first contraction are rounded
  once to bf16 (8-bit mantissa, ~2e-3 each), accumulation is f32.
- f64 (jax_enable_x64): 1e-10. Both sides compute in IEEE f64; only the
  summation order differs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")

TOL = {"float32": 1e-4, "bfloat16": 5e-3, "float64": 1e-10}
COIL = (3, 128, 128, 7200)
RANK = 10


class Smoke:
    """Collects PASS/FAIL lines; a failed check fails its phase."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def log(self, msg: str):
        print(msg, flush=True)

    def check(self, name: str, ok: bool, detail: str = ""):
        self.log(f"  {'PASS' if ok else 'FAIL'} {name} {detail}".rstrip())
        if not ok:
            self.failed.append(name)

    def compare(self, name: str, got, ref, dtype: str):
        err = relerr(got, ref)
        self.check(name, bool(np.isfinite(err)) and err <= TOL[dtype],
                   f"relerr={err:.3e} tol={TOL[dtype]:g} ({dtype})")
        return err

    def timing(self, name: str, seconds: float):
        self.log(f"  TIME {name} {seconds * 1e3:.6f} ms [{self.card}]")


def relerr(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return float("inf")
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def timed(fn, *args, n: int = 10):
    """Seconds per call of ``fn(*args)``: one warm call, then ``n`` calls
    dispatched back to back and drained with block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


# ---------------------------------------------------------------------------
# Plain float64 references on the host
# ---------------------------------------------------------------------------


def _baseline():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import baseline_cpu
    return baseline_cpu


def coo_mttkrp_ref(idx, vals, Ws, mode):
    """sum over nonzeros of v * prod_{j != mode} W_j[idx_j] into row
    idx_mode (numpy f64)."""
    prod = vals[:, None].copy()
    for j, W in enumerate(Ws):
        if j != mode:
            prod = prod * W[idx[:, j]]
    s = Ws[mode].shape[0]
    return np.stack([np.bincount(idx[:, mode], weights=prod[:, r],
                                 minlength=s) for r in range(prod.shape[1])],
                    axis=1)


def coo_pair_ref(idx, vals, Ws, i, j):
    """Rank-major pair cache (R, s_i, s_j) of the COO tensor (numpy f64)."""
    prod = vals[:, None].copy()
    for k, W in enumerate(Ws):
        if k not in (i, j):
            prod = prod * W[idx[:, k]]
    si, sj = Ws[i].shape[0], Ws[j].shape[0]
    fused = idx[:, i].astype(np.int64) * sj + idx[:, j]
    return np.stack([np.bincount(fused, weights=prod[:, r],
                                 minlength=si * sj).reshape(si, sj)
                     for r in range(prod.shape[1])])


# ---------------------------------------------------------------------------
# Phase A: does block_until_ready wait on the card?
# ---------------------------------------------------------------------------


def phase_a(sm: Smoke, seed: int):
    """One executable runs ~1 s of dependent matmuls (an unrolled chain),
    so its dispatch returns at once; block_until_ready must then wait as
    long as a host pull of the result does. (A Python chain of dispatches
    would not show this: the GPU client stops accepting work a few dozen
    executions ahead, so dispatch itself blocks.)"""
    import jax
    import jax.numpy as jnp
    n = 8192
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    x0 = jax.random.normal(kx, (n, n), jnp.float32)
    y = jax.random.normal(ky, (n, n), jnp.float32) / np.sqrt(n)

    def chain_of(k):
        def chain(x, y):
            for _ in range(k):  # unrolled: a while_loop would make the
                # host poll its predicate, blocking the dispatch
                x = jnp.tanh(jnp.matmul(x, y,
                                        precision=jax.lax.Precision.HIGHEST))
            return x
        return jax.jit(chain)

    per = timed(chain_of(4), x0, y, n=3) / 4
    k = max(int(1.0 / per), 1)
    chain = chain_of(k)
    jax.block_until_ready(chain(x0, y))
    t0 = time.perf_counter()
    x = chain(x0, y)
    t_dispatch = time.perf_counter() - t0
    jax.block_until_ready(x)
    t_block = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = chain(x0, y)
    float(np.asarray(x[0, 0]))
    t_pull = time.perf_counter() - t0
    sm.log(f"  one executable of {k} dependent {n}x{n} f32 matmuls: "
           f"dispatch {t_dispatch:.6f} s, block_until_ready {t_block:.6f} "
           f"s, host pull {t_pull:.6f} s")
    sm.check("A block_until_ready waits for the card",
             abs(t_block - t_pull) <= 0.1 * t_pull
             and t_dispatch < 0.1 * t_block,
             f"(|block-pull|/pull={abs(t_block - t_pull) / t_pull:.4f} <= "
             f"0.1, dispatch/block={t_dispatch / t_block:.4f} < 0.1)")


# ---------------------------------------------------------------------------
# Phase B: contractions against float64 references
# ---------------------------------------------------------------------------


def copy_bandwidth(sm: Smoke) -> float:
    """Device-to-device bandwidth of a 4 GiB negate (reads and writes every
    byte once), best of 5 — the roofline the MTTKRP shares refer to."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones((1 << 30,), jnp.float32)
    neg = jax.jit(lambda a: -a)
    best = min(timed(neg, x, n=3) for _ in range(5))
    bw = 2 * x.nbytes / best
    sm.log(f"  copy bandwidth {bw / 1e9:.1f} GB/s (4 GiB negate, "
           f"{best * 1e3:.6f} ms) [{sm.card}]")
    del x
    return bw


def coil_contractions(sm: Smoke, seed: int, shape=COIL, R=RANK):
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp
    from pairwise_perturbation_tpu.ops import contract
    bl = _baseline()
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(shape) + 1)
    # zero-mean data: sums cancel, so a TF32 product cannot hide
    V = jax.random.normal(keys[0], shape, jnp.float32)
    Ws = [jax.random.normal(k, (s, R), jnp.float32)
          for k, s in zip(keys[1:], shape)]
    Vh = np.asarray(V, np.float64)
    Wh = [np.asarray(W, np.float64) for W in Ws]
    pr = contract.contraction_priority(shape)
    refs = [bl.np_mttkrp_chain(Vh, Wh, m, pr) for m in range(len(shape))]
    s_ref, p_ref = bl.np_build_pp_caches(Vh, Wh, pr)
    sweep_ref, grads_ref = bl.np_dt_sweep(Vh, Wh, pr)
    tag = "x".join(map(str, shape))
    mttkrp = jax.jit(contract.mttkrp, static_argnums=2)
    lam = jnp.asarray(0.0, jnp.float32)

    def check_all(Vd, Wd, dtype, lam):
        for m in range(len(shape)):
            sm.compare(f"B {tag} mttkrp mode {m}", mttkrp(Vd, Wd, m),
                       refs[m], dtype)
        if dtype == "bfloat16":
            return
        single, pair = cp.pp_build_caches(Vd, Wd)
        for i in range(len(shape)):
            sm.compare(f"B {tag} pp single {i}", single[i], s_ref[i], dtype)
        for (i, j), T in sorted(pair.items()):
            sm.compare(f"B {tag} pp pair {i}{j}", np.asarray(T)
                       .transpose(1, 2, 0), p_ref[(i, j)], dtype)
        Ws2, grads = cp.dt_sweep(Vd, Wd, lam, solver="svd")
        for i in range(len(shape)):
            sm.compare(f"B {tag} dt_sweep factor {i}", Ws2[i], sweep_ref[i],
                       dtype)
            sm.compare(f"B {tag} dt_sweep grad {i}", grads[i], grads_ref[i],
                       dtype)

    check_all(V, Ws, "float32", lam)
    check_all(V.astype(jnp.bfloat16), Ws, "bfloat16", lam)
    del V
    gc.collect()
    with jax.enable_x64(True):
        V64 = jnp.asarray(Vh)
        W64 = [jnp.asarray(W) for W in Wh]
        check_all(V64, W64, "float64", jnp.asarray(0.0, jnp.float64))
        del V64


def device_seconds(fn, *args, n: int = 20) -> float:
    """Device time per call of ``fn(*args)``: the summed durations of the
    kernels on the card's stream lines in a jax.profiler trace of ``n``
    calls, divided by ``n``."""
    import glob
    import tempfile
    import jax
    jax.block_until_ready(fn(*args))
    trace_dir = tempfile.mkdtemp(dir=OUT)
    jax.profiler.start_trace(trace_dir)
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    total = 0
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    total += sum(ev.duration_ns for ev in line.events)
    shutil.rmtree(trace_dir)
    return total / n / 1e9


def order3(sm: Smoke, seed: int, bw: float, sizes=(200, 512), R=RANK):
    """Order-3 MTTKRP (BASELINE config 1): the Triton-route kernel and the
    XLA chain against the f64 reference at 200^3, their device times
    against a read-V-once roofline, and the CP-ALS sweep with each."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from pairwise_perturbation_tpu.ops import contract, solve
    from pairwise_perturbation_tpu.ops.kernels import mttkrp3_triton
    sm.check("B order-3 f32 routes to the kernel on this card",
             contract.mttkrp3_kernel_applies(
                 jax.ShapeDtypeStruct((8, 8, 8), jnp.float32)))
    impls = {"kernel": mttkrp3_triton.mttkrp3, "xla": contract.mttkrp_xla}

    def sweep(V, Ws, *, impl):
        Ws = list(Ws)
        for i in range(3):
            M = impl(V, Ws, i)
            S = contract.hadamard_gram(Ws, skip_mode=i)
            Ws[i] = solve.svd_solve(M, S)
        return contract.normalize_factors(Ws)

    for s in sizes:
        os.makedirs(OUT, exist_ok=True)
        keys = jax.random.split(jax.random.PRNGKey(seed + s), 4)
        V = jax.random.normal(keys[0], (s, s, s), jnp.float32)
        Ws = [jax.random.normal(k, (s, R), jnp.float32) for k in keys[1:]]
        if s == sizes[0]:
            Vh = np.asarray(V, np.float64)
            Wh = [np.asarray(W, np.float64) for W in Ws]
            bl = _baseline()
            for m in range(3):
                ref = bl.np_mttkrp_chain(Vh, Wh, m, (0, 1, 2))
                for name, impl in impls.items():
                    sm.compare(f"B order3 {s}^3 mttkrp mode {m} [{name}]",
                               impl(V, Ws, m), ref, "float32")
        for m in range(3):
            for name, impl in impls.items():
                t = device_seconds(jax.jit(partial(impl, mode=m)), V, Ws)
                sm.timing(f"order3 {s}^3 mttkrp mode {m} [{name}] device",
                          t)
                sm.log(f"  ROOFLINE order3 {s}^3 mode {m} [{name}]: "
                       f"{V.nbytes / t / bw:.4f} of the measured copy "
                       "bandwidth (read V once)")
        fs = {name: jax.jit(partial(sweep, impl=impl))
              for name, impl in impls.items()}
        for name in ("xla", "kernel", "kernel", "xla"):
            sm.timing(f"order3 {s}^3 CP-ALS sweep [{name}] host clock",
                      timed(fs[name], V, Ws, n=200))
        for name in ("xla", "kernel"):
            sm.timing(f"order3 {s}^3 CP-ALS sweep [{name}] device",
                      device_seconds(fs[name], V, Ws))
        del V, Ws
        gc.collect()


def sparse_fixture(seed: int, shape=(200, 200, 200, 200), nnz=1_600_000,
                   R=RANK):
    """The sparse benchmark fixture: uniform random indices and values."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import sparse as spo
    k = jax.random.split(jax.random.PRNGKey(seed + 7), len(shape) + 2)
    idx = jnp.stack([jax.random.randint(k[i], (nnz,), 0, s)
                     for i, s in enumerate(shape)], axis=1).astype(jnp.int32)
    vals = jax.random.uniform(k[-2], (nnz,), jnp.float32)
    Ws = [jax.random.normal(jax.random.fold_in(k[-1], i), (s, R),
                            jnp.float32) for i, s in enumerate(shape)]
    return spo.SparseTensor(idx, vals, shape), Ws


def sparse_contractions(sm: Smoke, seed: int, nnz=1_600_000,
                        timing_nnz=(1_600_000, 100_000)):
    import jax
    from functools import partial
    from pairwise_perturbation_tpu.ops import sparse as spo
    st, Ws = sparse_fixture(seed, nnz=nnz)
    idx = np.asarray(st.indices)
    vals = np.asarray(st.values, np.float64)
    Wh = [np.asarray(W, np.float64) for W in Ws]
    order = st.ndim
    for method in ("onehot", "native"):
        for m in range(order):
            got = spo.mttkrp(st, Ws, m, method=method)
            sm.compare(f"B sparse mttkrp mode {m} [{method}]", got,
                       coo_mttkrp_ref(idx, vals, Wh, m), "float32")
        single, pair = jax.jit(partial(spo.build_pp_caches,
                                       method=method))(st, Ws)
        for i in range(order):
            sm.compare(f"B sparse pp single {i} [{method}]", single[i],
                       coo_mttkrp_ref(idx, vals, Wh, i), "float32")
        for (i, j), T in sorted(pair.items()):
            sm.compare(f"B sparse pp pair {i}{j} [{method}]", T,
                       coo_pair_ref(idx, vals, Wh, i, j), "float32")
    del st
    for n in timing_nnz:
        st, Ws = sparse_fixture(seed, nnz=n)
        for method in ("onehot", "native"):
            f = jax.jit(partial(spo.mttkrp, mode=0, method=method))
            sm.timing(f"sparse nnz={n} mttkrp [{method}]",
                      min(timed(f, st, Ws, n=20) for _ in range(2)))
            g = jax.jit(partial(spo.build_pp_caches, method=method))
            sm.timing(f"sparse nnz={n} pp cache build [{method}]",
                      timed(g, st, Ws, n=10))
        del st


def eigh_crossover(sm: Smoke, seed: int, sides=(64, 128, 256, 512), r=10):
    """Exact eigh against two warm-started subspace iterations (the Tucker
    AUTO extraction threshold, models/tucker.AUTO_SUBSPACE_MIN_SIDE)."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import tucker
    from pairwise_perturbation_tpu.ops import solve
    for side in sides:
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + side))
        A = jax.random.normal(k1, (side, 2 * side), jnp.float32)
        G = A @ A.T
        Q0 = jnp.linalg.qr(jax.random.normal(k2, (side, r), jnp.float32))[0]
        t_eigh = timed(jax.jit(lambda G: solve.truncated_eigh(G, r)), G,
                       n=20)
        t_sub = timed(jax.jit(lambda G, Q0: tucker._topk_subspace(
            G, r, Q0, 2)), G, Q0, n=20)
        sm.timing(f"Gram side {side}: eigh", t_eigh)
        sm.timing(f"Gram side {side}: 2 warm subspace iterations (r={r})",
                  t_sub)


def phase_b(sm: Smoke, seed: int):
    bw = copy_bandwidth(sm)
    coil_contractions(sm, seed)
    gc.collect()
    order3(sm, seed, bw)
    sparse_contractions(sm, seed)
    eigh_crossover(sm, seed)


# ---------------------------------------------------------------------------
# Phase C: main path end to end
# ---------------------------------------------------------------------------


def low_rank_tensor(seed: int, shape=COIL, R=RANK, noise=0.1):
    """A rank-R CP tensor with uniform(0,1) factors plus 10% relative
    Gaussian noise, made on the device (f32). At this noise level the f32
    norm identity resolves diffV to ~1e-5 relative; at 1% it would not
    resolve the 1e-3 f32-vs-f64 check below."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import contract
    keys = jax.random.split(jax.random.PRNGKey(seed + 11), len(shape) + 1)
    Fs = [jax.random.uniform(k, (s, R), jnp.float32)
          for k, s in zip(keys[1:], shape)]
    V = contract.build_dense(Fs)
    E = jax.random.normal(keys[0], shape, jnp.float32)
    return V + noise * jnp.linalg.norm(V) / jnp.linalg.norm(E) * E


def library_api(sm: Smoke, seed: int, shape=COIL, R=RANK, sweeps=30):
    """cp.als_cp_dt and cp.als_cp_pp, same seed and init, f32 and f64."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp
    V32 = low_rank_tensor(seed, shape, R)
    W32 = cp.init_factors(shape, R, key=jax.random.PRNGKey(seed),
                          dtype=jnp.float32)
    eps32 = float(np.finfo(np.float32).eps)
    final = {}
    for dtype in ("float32", "float64"):
        with jax.enable_x64(dtype == "float64"):
            jdt = jnp.float32 if dtype == "float32" else jnp.float64
            V = V32.astype(jdt)
            Ws = [W.astype(jdt) for W in W32]
            for name, solver, kw in (("als_cp_dt", cp.als_cp_dt, {}),
                                     ("als_cp_pp", cp.als_cp_pp,
                                      dict(pp_res_tol=0.05))):
                cfg = cp.CPConfig(maxiter=sweeps, resprint=1, tol=0.0, **kw)
                t0 = time.perf_counter()
                res = solver(V, list(Ws), cfg)
                wall = time.perf_counter() - t0
                dv = [h["diffV"] for h in res.history]
                pp_rows = sum(h["pp"] for h in res.history)
                rise = max([b - a for a, b in zip(dv, dv[1:])] + [0.0])
                # diffV comes from the norm identity ||V||^2 - 2<M,W> +
                # sum(S): in f32 each term carries ~eps ||V||^2, so diffV
                # is resolved to ~4 eps ||V||^2 / diffV (the documented
                # f32 diffV clamp); f64 must not rise at all
                slack = 0.0 if dtype == "float64" else \
                    4 * eps32 * float(cp.contract.norm_sq(V32)) / min(dv)
                sm.log(f"  {name} {dtype}: {res.iters} sweeps, diffV "
                       f"{dv[0]:.6e} -> {dv[-1]:.6e}, {pp_rows} PP rows, "
                       f"dtime {res.history[-1]['dtime']:.6f} s, wall "
                       f"{wall:.3f} s, {res.iters / res.history[-1]['dtime']:.4f}"
                       f" sweeps/s [{sm.card}]")
                sm.check(f"C {name} {dtype} diffV non-increasing",
                         rise <= slack and np.isfinite(dv[-1]),
                         f"(largest rise {rise:.3e} <= {slack:.3e})")
                if name == "als_cp_pp":
                    sm.check(f"C {name} {dtype} reached the PP phase",
                             pp_rows > 0, f"({pp_rows} PP rows)")
                final[(name, dtype)] = dv[-1]
            if dtype == "float32":
                _sweep_times(sm, cp, V, Ws)
            del V
    for name in ("als_cp_dt", "als_cp_pp"):
        a, b = final[(name, "float32")], final[(name, "float64")]
        sm.check(f"C {name} final diffV f32 vs f64", abs(a - b) <= 1e-3 * b,
                 f"(relative {abs(a - b) / b:.3e} <= 1e-3)")


def _sweep_times(sm: Smoke, cp, V, Ws):
    import jax.numpy as jnp
    lam = jnp.asarray(0.0, V.dtype)
    sm.timing("coil f32 DT sweep",
              timed(lambda Ws: cp.dt_sweep(V, Ws, lam)[0], Ws, n=20))
    sm.timing("coil f32 PP cache build",
              timed(lambda Ws: cp.pp_build_caches(V, Ws), Ws, n=10))
    single, pair = cp.pp_build_caches(V, Ws)
    zeros = [jnp.zeros_like(W) for W in Ws]
    sm.timing("coil f32 PP sweep",
              timed(lambda Ws: cp.pp_sweep(single, pair, Ws, Ws, zeros, lam,
                                           1.0)[0], Ws, n=20))


def _read_csv(path):
    with open(path) as fh:
        rows = [line.strip().split(",") for line in fh if line.strip()]
    head = rows[0]
    return [dict(zip(head, map(float, r))) for r in rows[1:]]


def _cli_main(argv):
    """cli.main(argv) with its stdout captured; returns (rc, ||V||), the
    norm as ``test_als`` prints it (nan for drivers that do not)."""
    import contextlib
    import io
    import re
    from pairwise_perturbation_tpu import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    found = re.search(r"Vnorm= (\S+)", out.getvalue())
    return rc, float(found.group(1)) if found else float("nan")


def cli_run(sm: Smoke, label: str, argv, strict: bool = True):
    """One in-process CLI run; checks rc 0 and a decreasing [diffV]. With
    ``strict`` off (Tucker from an HOSVD start already within f32
    resolution of the optimum) diffV may only not rise by more than the
    resolution of its norm identity, sqrt(8 eps) ||V||."""
    os.makedirs(OUT, exist_ok=True)
    csv = os.path.join(OUT, f"{label}.csv")
    t0 = time.perf_counter()
    rc, vnorm = _cli_main(list(argv) + ["-filename", csv])
    wall = time.perf_counter() - t0
    rows = _read_csv(csv)
    it_key = "[iter]"
    dv = [r["[diffV]"] for r in rows]
    per = (rows[-1]["[dtime]"] - rows[0]["[dtime]"]) / max(
        rows[-1][it_key] - rows[0][it_key], 1)
    sm.log(f"  {label}: rc {rc}, {len(rows)} rows, iter "
           f"{rows[0][it_key]:g} -> {rows[-1][it_key]:g}, diffV "
           f"{dv[0]:.6e} -> {dv[-1]:.6e}, {per * 1e3:.6f} ms/sweep (dtime), "
           f"wall {wall:.3f} s incl. set-up [{sm.card}]")
    floor = np.sqrt(8 * np.finfo(np.float32).eps) * vnorm
    fell = dv[-1] < dv[0] if strict else dv[-1] <= dv[0] + floor
    sm.check(f"C cli {label}", rc == 0 and all(np.isfinite(dv)) and fell,
             f"(rc {rc}, diffV " + ("decreased)" if strict else
                                    f"rose by at most {floor:.3e})"))
    return rows


def cli_deployments(sm: Smoke, seed: int, maxiter: int = 20):
    from pairwise_perturbation_tpu.utils import synth
    t0 = time.perf_counter()
    synth.make_tensor("r", 6, 32, 4, seed=seed)
    sm.log(f"  set-up: host generation of the 32^6 rank-4 tensor "
           f"{time.perf_counter() - t0:.3f} s (numpy, utils/synth.py)")
    weak = ["-tensor", "r", "-dim", "6", "-size", "32", "-rank", "4",
            "-maxiter", str(maxiter), "-seed", str(seed)]
    cli_run(sm, "weak_cp_dt", ["test_als", "-model", "CP", "-pp", "0"]
            + weak)
    cli_run(sm, "weak_cp_pp_loop0", ["test_als", "-model", "CP", "-pp", "1",
                                     "-device_loop", "0"] + weak)
    cli_run(sm, "weak_cp_pp_loop2", ["test_als", "-model", "CP", "-pp", "1",
                                     "-device_loop", "2"] + weak)
    # Tucker starts from HOSVD, which for r2 (uniform random data) and for
    # the Poisson operator (multilinear rank 2 per folded mode) is already
    # within f32 resolution of HOOI's optimum: diffV can only stay level
    weak_r2 = ["-tensor", "r2"] + weak[2:]
    cli_run(sm, "weak_tucker_pp", ["test_als", "-model", "Tucker", "-pp",
                                   "1"] + weak_r2, strict=False)
    cli_run(sm, "weak_run_msdt", ["run", "-pp", "1"] + weak)
    poisson = ["-tensor", "p", "-dim", "8", "-size", "13", "-rank", "2",
               "-pp", "1", "-issparse", "1", "-maxiter", str(maxiter),
               "-seed", str(seed)]
    cli_run(sm, "poisson_cp_sparse", ["test_als", "-model", "CP"] + poisson)
    cli_run(sm, "poisson_tucker_sparse", ["test_als", "-model", "Tucker"]
            + poisson, strict=False)


def phase_c(sm: Smoke, seed: int):
    library_api(sm, seed)
    gc.collect()
    cli_deployments(sm, seed)


# ---------------------------------------------------------------------------
# Phase D: card-only tests
# ---------------------------------------------------------------------------


def phase_d(sm: Smoke):
    import pytest

    class Counts:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] = self.n.get(report.outcome, 0) + 1

    counts = Counts()
    rc = pytest.main(["-q", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests_gpu")], plugins=[counts])
    n = counts.n
    sm.check("D pytest tests_gpu", int(rc) == 0 and n["failed"] == 0
             and n["skipped"] == 0 and n["passed"] > 0,
             f"(rc {int(rc)}, {n})")


# ---------------------------------------------------------------------------
# Four cards (-mesh 4) against one card
# ---------------------------------------------------------------------------


def _in_use_gb():
    import jax
    return [(d.memory_stats() or {}).get("bytes_in_use", 0) / 1e9
            for d in jax.devices()]


def _placement_gb(argv):
    """Per-card bytes_in_use that placing V adds, placed the way
    ``test_als -mesh`` places it (cli._load_tensor on the host, then
    cli._maybe_shard); V is dropped again afterwards."""
    import jax
    from pairwise_perturbation_tpu import cli
    from pairwise_perturbation_tpu.utils import flags
    args = flags.build_parser("test_als").parse_args(list(argv[1:]))
    flags.clamp(args)
    V, _, pre = cli._load_tensor(args)
    before = _in_use_gb()
    Vd, _, _ = cli._maybe_shard(V, [], args, pre)
    jax.block_until_ready(Vd)
    after = _in_use_gb()
    del V, Vd
    gc.collect()
    return [a - b for a, b in zip(after, before)]


def _mesh_pair(sm: Smoke, label: str, argv, factor_tol=None, rows=(0,)):
    """Run ``argv`` with -mesh 4, then on one card, and report each card's
    peak memory. The logged rows at the iterations ``rows`` are compared:
    gradnorm within 1e-5 at iteration 0 (same factors, only the order of
    summation differs) and 1e-4 after (ten times the distance of sharded
    and unsharded factors after one sweep, 1.3e-5 on the Poisson CP fit);
    diffV, from a norm identity, within 1e-3 or the identity's f32
    resolution, 8 eps ||V||^2 / diffV. With ``factor_tol`` the final
    factors (checkpoints) and the final diffV are compared too (NCCL sums
    in another order than one card, so they agree up to rounding);
    without it the final state is reported."""
    import jax
    from pairwise_perturbation_tpu.utils import io as ppio
    os.makedirs(OUT, exist_ok=True)
    res = {}
    for tag, mesh in (("mesh4", ["-mesh", "4"]), ("one", [])):
        csv = os.path.join(OUT, f"{label}_{tag}.csv")
        ck = os.path.join(OUT, f"{label}_{tag}")
        t0 = time.perf_counter()
        rc, vnorm = _cli_main(list(argv) + mesh + ["-filename", csv,
                                                   "-checkpoint", ck])
        wall = time.perf_counter() - t0
        log = _read_csv(csv)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 1e9
                 for d in jax.devices()]
        gc.collect()
        sm.log(f"  {label} [{tag}]: rc {rc}, diffV {log[0]['[diffV]']:.6e}"
               f" -> {log[-1]['[diffV]']:.6e}, wall {wall:.3f} s incl. "
               f"set-up, peak GB per card since start "
               f"{[round(p, 3) for p in peaks]}, in use after the run "
               f"{[round(b, 3) for b in _in_use_gb()]} [{sm.card}]")
        res[tag] = (rc, {int(r["[iter]"]): r for r in log}, log[-1],
                    ppio.load_checkpoint(ck)["factors"], peaks)
    (rc4, by_it4, last4, f4, peaks4), (rc1, by_it1, last1, f1, peaks1) = \
        res["mesh4"], res["one"]
    sm.check(f"four {label} rc", rc4 == 0 and rc1 == 0)
    eps32 = float(np.finfo(np.float32).eps)

    def dv_tol(dv):  # a diffV clamped to 0 has the floor sqrt(8 eps)||V||
        return max(1e-3 * dv, 8 * eps32 * vnorm ** 2
                   / max(dv, np.sqrt(8 * eps32) * vnorm))

    for it in rows:
        r4, r1 = by_it4.get(it), by_it1.get(it)
        if r4 is None or r1 is None:
            sm.check(f"four {label} iteration {it} logged", False)
            continue
        if "[gradnorm]" in r1:
            a, b, tol = r4["[gradnorm]"], r1["[gradnorm]"], \
                1e-5 if it == 0 else 1e-4
            sm.check(f"four {label} iteration-{it} gradnorm vs one card",
                     abs(a - b) <= tol * abs(b),
                     f"({a:.7e} vs {b:.7e}, tol {tol:g})")
        a, b = r4["[diffV]"], r1["[diffV]"]
        sm.check(f"four {label} iteration-{it} diffV vs one card",
                 abs(a - b) <= dv_tol(b), f"(|{a:.7e} - {b:.7e}| <= "
                                          f"{dv_tol(b):.3e})")
    ferr = max(relerr(a, b) for a, b in zip(f4, f1))
    dv4, dv1 = last4["[diffV]"], last1["[diffV]"]
    if factor_tol is None:
        sm.log(f"  {label}: final factors differ by {ferr:.3e}, final "
               f"diffV {dv4:.6e} vs {dv1:.6e} (reported, not checked)")
        return peaks4, peaks1[0]
    sm.check(f"four {label} factors vs one card", ferr <= factor_tol,
             f"(max relerr {ferr:.3e} <= {factor_tol:g})")
    sm.check(f"four {label} diffV vs one card", abs(dv4 - dv1) <= dv_tol(dv1),
             f"(|{dv4:.6e} - {dv1:.6e}| <= {dv_tol(dv1):.3e})")
    return peaks4, peaks1[0]


def phase_four(sm: Smoke, seed: int, dense_size: int, dense_rank: int):
    import jax
    if len(jax.devices()) != 4:
        sm.check("four: four cards visible", False,
                 f"({len(jax.devices())} devices)")
        return
    dense = ["test_als", "-model", "CP", "-tensor", "r", "-pp", "1", "-dim",
             "6", "-rank", str(dense_rank), "-size", str(dense_size),
             "-maxiter", "20", "-seed", str(seed)]
    vbytes = 4 * dense_size ** 6 / 1e9
    # Placement: V alone, as the CLI places it, is a quarter of |V| on
    # every card (the size splits evenly over 4); 5% covers allocator
    # rounding. A V made whole on card 0 before sharding would show there.
    placed = _placement_gb(dense + ["-mesh", "4"])
    sm.check("four dense: placing V puts a quarter of it on every card",
             all(0.95 * vbytes / 4 <= p <= 1.05 * vbytes / 4 for p in placed),
             f"(|V| = {vbytes:.3f} GB, bytes_in_use added per card "
             f"{[round(p, 4) for p in placed]} GB, bound |V|/4 +- 5%)")
    # Peaks: V and the intermediates XLA keeps beside it (transposed
    # copies of V, autotuning scratch when nothing is cached). Sharding
    # takes three quarters of V off every card, so each mesh-run peak is
    # at most |V|/4 plus the intermediates of the one-card run (its peak
    # less |V|); a card 0 holding all of V besides its share would pass
    # that by 3/4 |V|. No card peaks more than 0.15 |V| above another
    # (autotuning on card 0 alone took 0.09 |V| uncached).
    # peak_bytes_in_use counts from process start: the mesh run goes
    # first, so its peaks are its own (the placement above peaks lower),
    # and card 0's peak after the one-card run is that run's.
    peaks, one = _mesh_pair(sm, f"weak_cp_pp_s{dense_size}", dense,
                            factor_tol=1e-3)
    bound = vbytes / 4 + (one - vbytes)
    sm.check("four dense: every card peaks at its quarter of V plus the "
             "one-card intermediates",
             all(0 < p <= bound for p in peaks)
             and max(peaks) - min(peaks) <= 0.15 * vbytes,
             f"(mesh peaks {[round(p, 3) for p in peaks]} <= {bound:.3f} GB"
             f" = |V|/4 + (one-card peak {one:.3f} - |V|), spread "
             f"{max(peaks) - min(peaks):.3f} <= {0.15 * vbytes:.3f})")
    poisson = ["-tensor", "p", "-dim", "8", "-size", "13", "-rank", "2",
               "-pp", "1", "-issparse", "1", "-seed", str(seed)]
    # Sparse CP: the rank-2 Poisson fit amplifies f32 rounding. From the
    # same start, f32 factors stand 8.4e-6 from f64 ones after one sweep
    # and 2.9e-3 after two, so runs that sum in another order (four cards
    # or one; atomic scatter-adds on every GPU run) part by that much
    # from the second sweep on. Its state is compared after one sweep
    # (the logged iteration-1 gradnorm and diffV); the final state of the
    # 20 sweeps is reported.
    _mesh_pair(sm, "poisson_cp_sparse", ["test_als", "-model", "CP"]
               + poisson + ["-maxiter", "20", "-resprint", "1"],
               rows=(0, 1))
    _mesh_pair(sm, "poisson_tucker_sparse", ["test_als", "-model", "Tucker"]
               + poisson + ["-maxiter", "20"], factor_tol=1e-3)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card -mesh path")
    # weak scaling at n = 4 is size 40, rank 5 (16.4 GB); its one-card
    # comparison does not fit one card (XLA's transposed copies of V), so
    # the comparison runs at the n = 1 size
    ap.add_argument("--four-size", type=int, default=32)
    ap.add_argument("--four-rank", type=int, default=4)
    ap.add_argument("--phases", default="ABCD",
                    help="subset of the one-card phases to run")
    args = ap.parse_args(argv)

    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found '{platform}'. "
              "Nothing was run.", file=sys.stderr)
        return 2
    try:
        from pairwise_perturbation_tpu import native
        from pairwise_perturbation_tpu.utils import compile_cache
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e}).",
              file=sys.stderr)
        return 2

    card = card_info()
    print(card, flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"compile cache: {compile_cache.configure()}", flush=True)
    print(f"visible devices: {len(jax.devices())} x "
          f"{jax.devices()[0].device_kind}", flush=True)
    print(f"native planner loaded: {native.available()}", flush=True)
    sm = Smoke(card)

    if args.four:
        phases = [("four", lambda: phase_four(sm, args.seed, args.four_size,
                                              args.four_rank))]
    else:
        table = {"A": lambda: phase_a(sm, args.seed),
                 "B": lambda: phase_b(sm, args.seed),
                 "C": lambda: phase_c(sm, args.seed),
                 "D": lambda: phase_d(sm)}
        phases = [(p, table[p]) for p in args.phases]
    for name, run in phases:
        t0 = time.perf_counter()
        sm.log(f"== phase {name}")
        before = len(sm.failed)
        try:
            run()
        except Exception as e:  # a crashed phase is a failed phase
            import traceback
            traceback.print_exc()
            sm.failed.append(f"phase {name}: {e!r}")
        gc.collect()
        status = "PASS" if len(sm.failed) == before else "FAIL"
        sm.log(f"== phase {name} {status} in "
               f"{time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    if sm.failed:
        print(f"chip_smoke: {len(sm.failed)} failed: {sm.failed}",
              file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
