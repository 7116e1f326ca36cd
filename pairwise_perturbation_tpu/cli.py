"""Command-line drivers — JAX equivalents of the reference binaries.

- ``python -m pairwise_perturbation_tpu.cli test_als ...``  <-> ``./test_ALS``
  (test_ALS.cxx: legacy engine, CP {DT, PP, PP-partupdate} and Tucker {DT, PP})
- ``python -m pairwise_perturbation_tpu.cli run ...``       <-> ``./run``
  (run.cxx: second-gen CPD with {DT, MSDT, DT-LR, MSDT-LR, Simple})
- ``python -m pairwise_perturbation_tpu.cli pp_bench ...``  <-> ``./pp_bench``
  (pp_bench.cxx: per-sweep [DTtime]/[PPfirst]/[PPsecond] timing)

Flags follow the reference surface (utils/flags.py). Example:

    python -m pairwise_perturbation_tpu.cli test_als -model CP -tensor r \\
        -pp 1 -dim 4 -size 24 -rank 8 -maxiter 100 -filename out.csv
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _np_dtype(name: str):
    """Factor-matrix dtype. ``bfloat16`` selects the *mixed-precision*
    mode: V is stored bf16 (halved memory traffic, bf16 products with f32
    accumulation in every contraction touching V) while factors, Gram
    matrices and solves stay f32 — see contract._einsum."""
    import jax.numpy as jnp
    return {"float32": jnp.float32, "float64": jnp.float64,
            "bfloat16": jnp.float32}[name]


def _v_dtype(name: str):
    """Dtype V is stored in on device."""
    import jax.numpy as jnp
    return {"float32": jnp.float32, "float64": jnp.float64,
            "bfloat16": jnp.bfloat16}[name]


def _dataset_path(args, default):
    return args.tensorfile if args.tensorfile != "test" else default


def _load_tensor(args):
    """Load/construct the tensor and canonicalize its mode order for
    (8, 128)-tiled layouts (utils.layout): e.g. time-lapse
    (33,1344,1024,9) puts its 1024-sized mode minor. Returns (V, perm,
    pre_layout);
    per-mode outputs must be mapped back with layout.unpermute_factors.

    With ``-mesh`` set and a file-backed tensor (o1/o2), the tensor is
    read SHARDED straight from disk (io.read_dense_sharded — the MPI-IO
    collective-read equivalent, test_ALS.cxx:291-304): each process only
    touches its devices' file spans, no host ever materializes the full
    tensor, and ``pre_layout`` carries the production ShardedLayout.
    """
    from pairwise_perturbation_tpu.utils import io as ppio, synth
    name = args.tensor
    dt = np.float64 if args.dtype == "float64" else np.float32
    if args.mesh and name in ("o1", "o2"):
        return _load_tensor_sharded(args)
    if name == "o1":
        V = ppio.load_coil100(_dataset_path(args, "coil-100.bin"),
                              out_dtype=dt)
    elif name == "o2":
        V = ppio.load_time_lapse(_dataset_path(args, "time-lapse.bin"),
                                 out_dtype=dt)
    else:
        V = synth.make_tensor(name, args.dim, args.size, args.rank,
                              args.colmin, args.colmax, args.rationoise,
                              seed=args.seed, dtype=dt)
    from pairwise_perturbation_tpu.utils import layout
    V, perm = layout.canonicalize(V)
    if perm != tuple(range(V.ndim)) and not args.quiet:
        print(f"  canonicalized mode order for tiling: perm={perm}")
    return V, perm, None


def _load_tensor_sharded(args):
    """Sharded-from-disk dataset load for ``-mesh`` runs (o1/o2).

    Composes the CTF axis reversal (column-major global order, utils/io.py)
    with the tile canonicalization into one axes_perm view of the
    on-disk array, plans the production layout on the FINAL mode order,
    and block-reads per device.
    """
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    from pairwise_perturbation_tpu.utils import io as ppio
    from pairwise_perturbation_tpu.utils import layout as tlayout
    if args.tensor == "o1":
        file_shape = ppio.COIL100_FILE_SHAPE
        path = _dataset_path(args, "coil-100.bin")
    else:
        file_shape = ppio.TIME_LAPSE_FILE_SHAPE
        path = _dataset_path(args, "time-lapse.bin")
    nd = len(file_shape)
    ctf_shape = tuple(reversed(file_shape))
    perm = tlayout.canonical_perm_or_identity(ctf_shape)
    final_shape = tuple(ctf_shape[p] for p in perm)
    mesh = pmesh.make_mesh(tuple(int(x) for x in args.mesh.split("x")))
    layout = pmesh.plan_layout(final_shape, mesh)
    axes = tuple(nd - 1 - perm[i] for i in range(nd))
    dt = np.float64 if args.dtype == "float64" else np.float32
    V = ppio.read_dense_sharded(path, layout, out_dtype=dt,
                                file_shape=file_shape, axes_perm=axes)
    if not args.quiet:
        print(f"  sharded read: {path} -> {final_shape} (perm {perm}) "
              f"padded {layout.padded_shape} over mesh {args.mesh}")
    return V, perm, layout


def _maybe_shard(V, Ws, args, pre_layout=None):
    """Shard V (and factors) over the ``-mesh`` device mesh. Every driver
    honors this — the reference runs ALL binaries over the full MPI world
    (test_ALS.cxx:364-396 runs Tucker on the same CTF-sharded tensors).
    ``pre_layout``: layout of an already-sharded-from-disk V."""
    if not args.mesh:
        return V, Ws, None
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    if pre_layout is not None:
        Wss = pmesh.shard_factors(Ws, pre_layout) if Ws else Ws
        return V, Wss, pre_layout
    shape = tuple(int(x) for x in args.mesh.split("x"))
    mesh = pmesh.make_mesh(shape)
    layout = pmesh.plan_layout(V.shape, mesh)
    Vs = pmesh.shard_tensor(V, layout)
    Wss = pmesh.shard_factors(Ws, layout) if Ws else Ws
    return Vs, Wss, layout


def _unshard_result_factors(res, layout):
    """Gather sharded factors and strip layout padding rows in place."""
    if layout is not None:
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        res.factors = pmesh.unshard_factors(res.factors, layout)
    return res


def _print_banner(args):
    if args.quiet:
        return
    print(f"  model=  {args.model}  tensor=  {args.tensor}  pp=  {args.pp}")
    print(f"  dim=  {args.dim}  size=  {args.size}  rank=  {args.rank}")
    print(f"  tolerance=  {args.tol}  restarttol=  {args.pp_res_tol}")
    print(f"  lambda=  {args.lam}  magnitude=  {args.magni}"
          f"  filename=  {args.filename}")
    print(f"  timelimit=  {args.timelimit}  maxiter=  {args.maxiter}"
          f"  resprint=  {args.resprint}")
    print(f"  dtype=  {args.dtype}  mesh=  {args.mesh or '1'}")


def _planned_split(args, shape):
    """Native-planner binary-tree root split (None = reference midpoint).

    Objective: memory traffic, not FLOPs — the first-level DT
    contractions are bandwidth-bound, so bytes moved is what predicts
    sweep time (a FLOP model over-promises on coil's skewed shape)."""
    if not getattr(args, "planner", 0):
        return None
    from pairwise_perturbation_tpu import native
    split, best_t, mid_t = native.plan_tree_split_traffic(
        tuple(int(s) for s in shape), int(args.rank))
    if split == (len(shape) - 1) // 2:
        return None  # planner agrees with the midpoint: share the jit cache
    if not args.quiet and mid_t == mid_t and best_t == best_t and mid_t > 0:
        print(f"  planner: root split {split} "
              f"(modeled traffic saving {100 * (mid_t - best_t) / mid_t:.1f}%"
              " vs midpoint)")
    return split


def _tucker_ranks(args, V):
    if args.tensor == "o1":
        return (3, 10, 10, 70)          # test_ALS.cxx:368-373
    if args.tensor == "o2":
        return (10, 100, 100, 5)        # test_ALS.cxx:375-380
    return tuple([args.rank] * V.ndim)


def cmd_test_als(args) -> int:
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp, tucker
    from pairwise_perturbation_tpu.utils.metrics import PlotFile
    import jax

    from pairwise_perturbation_tpu.utils import layout as tlayout
    _print_banner(args)
    V, perm, pre_layout = _load_tensor(args)
    if isinstance(V, np.ndarray):
        Vnorm = float(np.linalg.norm(V.ravel()))
    else:  # sharded device array: norm without gathering to host
        from pairwise_perturbation_tpu.ops import contract as _ctr
        Vnorm = float(jnp.sqrt(_ctr.norm_sq(V)))
    if not args.quiet:
        print(f"Vnorm= {Vnorm}")
    if args.dtype == "bfloat16":
        V = jnp.asarray(V, dtype=_v_dtype(args.dtype))
    t0 = time.perf_counter()

    if args.model == "CP" and args.issparse:
        return _cmd_test_als_sparse(args, V, perm, Vnorm)
    if args.model == "Tucker" and args.issparse:
        return _cmd_test_als_sparse_tucker(args, V, perm, Vnorm)
    if args.model == "CP":
        if args.resume:
            from pairwise_perturbation_tpu.utils import io as ppio
            ck = ppio.load_checkpoint(args.resume)
            Ws = [jnp.asarray(ck["factors"][m], dtype=_np_dtype(args.dtype))
                  for m in perm]
            if not args.quiet:
                print(f"resumed {len(Ws)} factors from {args.resume} "
                      f"(iteration {ck['iteration']})")
        else:
            # factors are initialized at the ORIGINAL mode sizes; for a
            # sharded-from-disk (padded) V, shard_factors then zero-pads
            # the rows — padding rows must be zero for the layout
            # invariant (parallel/mesh.py), not random values
            init_shape = pre_layout.orig_shape if pre_layout else V.shape
            Ws = cp.init_factors(init_shape, args.rank,
                                 key=jax.random.PRNGKey(args.seed),
                                 dtype=_np_dtype(args.dtype))
        Vd, Ws, layout = _maybe_shard(V, Ws, args, pre_layout)
        cfg = cp.CPConfig(tol=args.tol * Vnorm, pp_res_tol=args.pp_res_tol,
                          lam=args.lam, ratio_step=args.magni,
                          maxiter=args.maxiter, timelimit=args.timelimit,
                          resprint=args.resprint,
                          update_percentage=args.update_percentage_pp,
                          precompute_layouts=bool(args.layouts),
                          mesh_layout=layout,
                          tree_split=_planned_split(args, Vd.shape))
        plot = PlotFile(args.filename, PlotFile.CP_HEADER, echo=not args.quiet)
        if args.pp == 0:
            res = cp.als_cp_dt(Vd, Ws, cfg, plot)
        elif args.pp == 1:
            if args.device_loop >= 2:
                res = cp.als_cp_pp_fused(Vd, Ws, cfg, plot)
            elif args.device_loop:
                res = cp.als_cp_pp_device(Vd, Ws, cfg, plot)
            else:
                res = cp.als_cp_pp(Vd, Ws, cfg, plot)
        else:
            res = cp.als_cp_pp(Vd, Ws, cfg, plot, partial_update=True)
        plot.close()
        _unshard_result_factors(res, layout)
        if args.checkpoint:
            from pairwise_perturbation_tpu.utils import io as ppio
            ppio.save_checkpoint(
                args.checkpoint,
                tlayout.unpermute_factors(res.factors, perm), res.iters,
                meta=dict(model="CP", tensor=args.tensor))
        if not args.quiet:
            print(f"\nIter = {res.iters} Final grad norm {res.gradnorm:E}")
    else:
        ranks = tlayout.permute_tuple(_tucker_ranks(args, V), perm)
        # Tucker factors come from HOSVD on the (sharded) tensor, so only
        # V is sharded here; zero-padding is invisible to the mode Grams
        # (padded rows/cols of G are zero -> top-k eigenvectors have zero
        # padded entries) and to every TTMc.
        Vd, _, layout = _maybe_shard(V, [], args, pre_layout)
        cfg = tucker.TuckerConfig(tol=args.tol * Vnorm,
                                  pp_res_tol=args.pp_res_tol,
                                  maxiter=args.maxiter,
                                  timelimit=args.timelimit,
                                  resprint=args.resprint,
                                  subspace_iters=args.tucker_subspace,
                                  pp_quiet_frac=args.tucker_pp_skip,
                                  mesh_layout=layout)
        plot = PlotFile(args.filename, PlotFile.TUCKER_HEADER,
                        echo=not args.quiet)
        if args.pp == 0:
            res = tucker.als_tucker(Vd, ranks, cfg, plot)
        else:
            if args.device_loop >= 2:
                res = tucker.als_tucker_pp_fused(Vd, ranks, cfg, plot)
            elif args.device_loop:
                res = tucker.als_tucker_pp_device(Vd, ranks, cfg, plot)
            else:
                res = tucker.als_tucker_pp(Vd, ranks, cfg, plot)
        plot.close()
        _unshard_result_factors(res, layout)
        if args.checkpoint:
            from pairwise_perturbation_tpu.utils import io as ppio
            ppio.save_checkpoint(
                args.checkpoint,
                tlayout.unpermute_factors(res.factors, perm), res.iters,
                core=tlayout.unpermute_core(res.core, perm),
                meta=dict(model="Tucker", tensor=args.tensor))
        if not args.quiet:
            print(f"\nIter = {res.iters} Final Diff norm {res.diffnorm:E}")
    if not args.quiet:
        print(f"experiment took {time.perf_counter() - t0:.6f} seconds")
    return 0


def _cmd_test_als_sparse(args, V, perm, Vnorm) -> int:
    """Sparse CP path (-issparse 1): COO engine over the tensor's
    nonzeros. Natural fit: the laplacian family ('p'/'p2'), whose
    stencil structure is extremely sparse (common.cxx:575-642)."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp, sparse_cp
    from pairwise_perturbation_tpu.ops import sparse as spo
    from pairwise_perturbation_tpu.utils.metrics import PlotFile

    st = spo.from_dense(np.asarray(V, dtype=_np_dtype(args.dtype)
                                   if args.dtype != "float64"
                                   else np.float64))
    density = st.nnz / float(np.prod(st.shape))
    if not args.quiet:
        print(f"  sparse COO: nnz= {st.nnz}  density= {density:.4f}")
        if density > 0.25:
            print("  WARNING: tensor is dense-ish; the dense engine "
                  "(-issparse 0) will be faster")
    mesh = None
    if args.mesh:
        # nnz-sharded COO over a 1D mesh: per-shard partial MTTKRPs /
        # cache builds + one psum (parallel/mesh.shard_coo) — the
        # distributed sparse CTF tensor analogue (test_ALS.cxx:126-131)
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        mesh = pmesh.make_mesh(tuple(int(x) for x in args.mesh.split("x")))
        st = pmesh.shard_coo(st, mesh)
        if not args.quiet:
            print(f"  sharded COO: nnz split over {args.mesh} devices")
    Ws = cp.init_factors(st.shape, args.rank,
                         key=jax.random.PRNGKey(args.seed),
                         dtype=_np_dtype(args.dtype))
    cfg = cp.CPConfig(tol=args.tol * Vnorm, pp_res_tol=args.pp_res_tol,
                      lam=args.lam, ratio_step=args.magni,
                      maxiter=args.maxiter, timelimit=args.timelimit,
                      resprint=args.resprint)
    plot = PlotFile(args.filename, PlotFile.CP_HEADER, echo=not args.quiet)
    if args.pp == 0:
        res = sparse_cp.als_cp_sparse(st, Ws, cfg, plot, mesh=mesh)
    else:
        res = sparse_cp.als_cp_pp_sparse(st, Ws, cfg, plot, mesh=mesh)
    plot.close()
    if args.checkpoint:
        from pairwise_perturbation_tpu.utils import io as ppio
        from pairwise_perturbation_tpu.utils import layout as tlayout
        ppio.save_checkpoint(
            args.checkpoint,
            tlayout.unpermute_factors(res.factors, perm), res.iters,
            meta=dict(model="CP", tensor=args.tensor, sparse=True))
    if not args.quiet:
        print(f"\nIter = {res.iters} Final grad norm {res.gradnorm:E}")
    return 0


def _cmd_test_als_sparse_tucker(args, V, perm, Vnorm) -> int:
    """Sparse Tucker path (-issparse 1 -model Tucker): COO engine with
    sparse-first TTMc sweeps and dense-shared PP sweeps
    (models/sparse_tucker.py). Reference: sparse CTF Tucker
    (test_ALS.cxx:229, 364-396)."""
    from pairwise_perturbation_tpu.models import sparse_tucker, tucker
    from pairwise_perturbation_tpu.ops import sparse as spo
    from pairwise_perturbation_tpu.utils import layout as tlayout
    from pairwise_perturbation_tpu.utils.metrics import PlotFile

    st = spo.from_dense(np.asarray(V, dtype=_np_dtype(args.dtype)
                                   if args.dtype != "float64"
                                   else np.float64))
    density = st.nnz / float(np.prod(st.shape))
    if not args.quiet:
        print(f"  sparse COO: nnz= {st.nnz}  density= {density:.4f}")
        if density > 0.25:
            print("  WARNING: tensor is dense-ish; the dense engine "
                  "(-issparse 0) will be faster")
    mesh = None
    init_st = None
    if args.mesh:
        # nnz-sharded COO over a 1D mesh: per-shard partial TTMcs /
        # cache builds + one psum (parallel/mesh.sharded_sparse_ttmc) —
        # the distributed sparse CTF Tucker analogue
        # (test_ALS.cxx:229, 364-396)
        from pairwise_perturbation_tpu.parallel import mesh as pmesh
        mesh = pmesh.make_mesh(tuple(int(x) for x in args.mesh.split("x")))
        init_st = st  # HOSVD init runs on the unsharded COO (setup)
        st = pmesh.shard_coo(st, mesh)
        if not args.quiet:
            print(f"  sharded COO: nnz split over {args.mesh} devices")
    ranks = tlayout.permute_tuple(_tucker_ranks(args, V), perm)
    cfg = tucker.TuckerConfig(tol=args.tol * Vnorm,
                              pp_res_tol=args.pp_res_tol,
                              maxiter=args.maxiter,
                              timelimit=args.timelimit,
                              resprint=args.resprint)
    plot = PlotFile(args.filename, PlotFile.TUCKER_HEADER,
                    echo=not args.quiet)
    if args.pp == 0:
        res = sparse_tucker.als_tucker_sparse(st, ranks, cfg, plot,
                                              mesh=mesh, init_st=init_st)
    else:
        res = sparse_tucker.als_tucker_pp_sparse(st, ranks, cfg, plot,
                                                 mesh=mesh,
                                                 init_st=init_st)
    plot.close()
    if args.checkpoint:
        from pairwise_perturbation_tpu.utils import io as ppio
        ppio.save_checkpoint(
            args.checkpoint,
            tlayout.unpermute_factors(res.factors, perm), res.iters,
            core=tlayout.unpermute_core(res.core, perm),
            meta=dict(model="Tucker", tensor=args.tensor, sparse=True))
    if not args.quiet:
        print(f"\nIter = {res.iters} Final Diff norm {res.diffnorm:E}")
    return 0


def cmd_run(args) -> int:
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp, optimizers as opt
    from pairwise_perturbation_tpu.utils.metrics import PlotFile

    _print_banner(args)
    V, perm, pre_layout = _load_tensor(args)
    if isinstance(V, np.ndarray):
        Vnorm = float(np.linalg.norm(V.ravel()))
    else:
        from pairwise_perturbation_tpu.ops import contract as _ctr
        Vnorm = float(jnp.sqrt(_ctr.norm_sq(V)))
    order = V.ndim
    init_shape = pre_layout.orig_shape if pre_layout else V.shape
    Ws = cp.init_factors(init_shape, args.rank,
                         key=jax.random.PRNGKey(args.seed),
                         dtype=_np_dtype(args.dtype))
    if args.issparse:
        # COO engine for the second-gen framework too (run.cxx:137-140):
        # first-level chain contractions run as fused-index segment_sums
        # over the nonzeros (optimizers.chain_top / lr_update_cache)
        from pairwise_perturbation_tpu.ops import sparse as spo
        Vd = spo.from_dense(np.asarray(V, dtype=_np_dtype(args.dtype)
                                       if args.dtype != "float64"
                                       else np.float64))
        layout = None
        if not args.quiet:
            print(f"  sparse COO: nnz= {Vd.nnz}  density= "
                  f"{Vd.nnz / float(np.prod(Vd.shape)):.4f}")
    else:
        Vd, Ws, layout = _maybe_shard(
            jnp.asarray(V, dtype=_v_dtype(args.dtype)), Ws, args,
            pre_layout)
    make = {
        0: lambda: opt.CPDTOptimizer(order, args.rank),
        1: lambda: opt.CPMSDTOptimizer(
            order, args.rank, min_holdout_size=args.msdt_min_holdout),
        2: lambda: opt.CPDTLROptimizer(order, args.rank, args.updaterank,
                                       bool(args.randomsvd)),
        3: lambda: opt.CPMSDTLROptimizer(
            order, args.rank, args.updaterank, bool(args.randomsvd),
            min_holdout_size=args.msdt_min_holdout),
        4: lambda: opt.CPSimpleOptimizer(order, args.rank),
    }[args.pp]
    model = opt.CPD(order, list(Vd.shape), args.rank, make())
    model.init(Vd, Ws, lam=args.lam)
    plot = PlotFile(args.filename, PlotFile.CP_HEADER, echo=not args.quiet)
    model.als(tol=args.tol * Vnorm, timelimit=args.timelimit,
              maxsweep=args.maxiter, resprint=args.resprint, plot=plot,
              macro=bool(args.device_loop))
    plot.close()
    if not args.quiet:
        print(f"\nFinal gradnorm {model.gradnorm:E}")
    return 0


def cmd_pp_bench(args) -> int:
    """Per-sweep timing: [DTtime] rows from 1-sweep DT runs, then
    [PPfirst]/[PPsecond] from 1-sweep PP runs, all from identical factors
    (pp_bench.cxx:277-348)."""
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp, tucker
    from pairwise_perturbation_tpu.utils.metrics import PlotFile

    from pairwise_perturbation_tpu.utils import layout as tlayout
    _print_banner(args)
    V, perm, pre_layout = _load_tensor(args)
    V = jnp.asarray(V, dtype=_v_dtype(args.dtype))
    Vnorm = float(jnp.linalg.norm(V.ravel()))
    plot = PlotFile(args.filename, PlotFile.BENCH_HEADER, echo=not args.quiet)

    if args.model == "CP":
        W0 = cp.init_factors(
            pre_layout.orig_shape if pre_layout else V.shape, args.rank,
            key=jax.random.PRNGKey(args.seed), dtype=_np_dtype(args.dtype))
        V, W0, _ = _maybe_shard(V, W0, args, pre_layout)
        lam = jnp.asarray(args.lam, dtype=V.dtype)
        split = _planned_split(args, V.shape)
        # warm up compiles (excluded, like CTF's first-touch costs are not)
        Ws, _ = cp.dt_sweep(V, [jnp.array(w) for w in W0], lam,
                            solver="svd", root_split=split)
        jax.block_until_ready(Ws)
        for _ in range(args.maxiter):
            Ws = [jnp.array(w) for w in W0]
            t0 = time.perf_counter()
            Ws, _ = cp.dt_sweep(V, Ws, lam, solver="svd", root_split=split)
            jax.block_until_ready(Ws)
            plot.bench_row("DTtime", time.perf_counter() - t0)
        # PP: cache build + first sweep, then steady-state sweep
        single, pair = cp.pp_build_caches(V, [jnp.array(w) for w in W0])
        jax.block_until_ready(single)
        for _ in range(args.maxiter):
            Ws = [jnp.array(w) for w in W0]
            t0 = time.perf_counter()
            single, pair = cp.pp_build_caches(V, Ws)
            W_init = [w for w in Ws]
            dWs = [jnp.zeros_like(w) for w in Ws]
            Ws, dWs, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam,
                                     args.magni, solver="svd")
            jax.block_until_ready(Ws)
            t1 = time.perf_counter()
            plot.bench_row("PPfirst", t1 - t0)
            Ws2, dWs2, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam,
                                       args.magni, solver="svd")
            jax.block_until_ready(Ws2)
            plot.bench_row("PPsecond", time.perf_counter() - t1)
    else:
        ranks = tlayout.permute_tuple(_tucker_ranks(args, V), perm)
        V, _, _ = _maybe_shard(V, [], args, pre_layout)
        core, Ws0 = tucker.hosvd(V, ranks)
        jax.block_until_ready(core)
        Ws, _ = tucker.tucker_dt_sweep(V, Ws0, Ws0, ranks=tuple(ranks),
                                       use_sign=True)
        jax.block_until_ready(Ws)
        for _ in range(args.maxiter):
            t0 = time.perf_counter()
            Ws, _ = tucker.tucker_dt_sweep(V, list(Ws0), Ws0,
                                           ranks=tuple(ranks), use_sign=True)
            jax.block_until_ready(Ws)
            plot.bench_row("DTtime", time.perf_counter() - t0)
        single, pair = tucker.tucker_build_caches(V, list(Ws0))
        jax.block_until_ready(single)
        for _ in range(args.maxiter):
            t0 = time.perf_counter()
            single, pair = tucker.tucker_build_caches(V, list(Ws0))
            W_init = [w for w in Ws0]
            dWs = [jnp.zeros_like(w) for w in Ws0]
            Ws, dWs, core, _ = tucker.tucker_pp_sweep(single, pair,
                                                      list(Ws0),
                                                      W_init, dWs,
                                                      ranks=tuple(ranks))
            jax.block_until_ready(Ws)
            t1 = time.perf_counter()
            plot.bench_row("PPfirst", t1 - t0)
            Ws2, dWs2, core2, _ = tucker.tucker_pp_sweep(
                single, pair, Ws, W_init, dWs, ranks=tuple(ranks))
            jax.block_until_ready(Ws2)
            plot.bench_row("PPsecond", time.perf_counter() - t1)
    plot.close()
    return 0


def main(argv=None) -> int:
    from pairwise_perturbation_tpu.utils import compile_cache, flags
    compile_cache.configure()
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = "test_als"
    if argv and argv[0] in ("test_als", "run", "pp_bench"):
        cmd = argv.pop(0)
    parser = flags.build_parser(f"pairwise_perturbation_tpu.cli {cmd}")
    args = parser.parse_args(argv)
    flags.clamp(args)
    if args.dtype == "float64":
        # The reference computes everything in double (CTF Tensor<> =
        # double, common.h). jax silently downcasts f64 -> f32 unless
        # x64 is enabled — a user asking for the reference's precision
        # must actually get it. The GPU runs f64 natively, at about half
        # the f32 rate for the bandwidth-bound contractions (twice the
        # bytes) and at the card's f64 rate for the rest.
        import jax
        jax.config.update("jax_enable_x64", True)
    sparse_mesh_ok = (not args.mesh
                      or (cmd == "test_als"
                          and args.model in ("CP", "Tucker")
                          and "x" not in args.mesh))
    if args.issparse and not (
            ((cmd == "test_als" and args.model in ("CP", "Tucker")
              and args.pp in (0, 1))
             or cmd == "run") and sparse_mesh_ok):
        # Sparse scope: legacy CP + Tucker engines (pp 0 plain ALS /
        # HOOI, pp 1 PP) and ALL second-gen run optimizers — matching
        # the reference's -issparse threading (test_ALS.cxx:126-131,
        # 229; run.cxx:137-140). -mesh with sparse: test_als CP or
        # Tucker over a 1D (nnz-sharded) mesh. Anything else fails
        # loudly.
        raise SystemExit(
            "-issparse 1 is supported for test_als -model {CP,Tucker} "
            "-pp {0,1} and for run (all optimizers); -mesh with sparse "
            "only for test_als CP/Tucker on a 1D mesh (nnz-sharded COO, "
            "parallel/mesh.shard_coo). Re-run without -issparse or "
            "adjust -mesh.")
    # Multi-host SPMD bring-up: no-op single-host, loud on a failed
    # coordinator handshake (parallel/mesh.py:distributed_init).
    from pairwise_perturbation_tpu.parallel import mesh as pmesh
    pmesh.distributed_init()
    if args.profile:
        from pairwise_perturbation_tpu.utils import tracing
        tracing.enable()
    tracing_device = bool(args.profile and args.trace_dir)
    if tracing_device:
        # device-level trace (the CTF Timer_epoch analogue at XLA op
        # granularity); view with xprof / tensorboard
        import jax
        jax.profiler.start_trace(args.trace_dir)
    try:
        rc = {"test_als": cmd_test_als, "run": cmd_run,
              "pp_bench": cmd_pp_bench}[cmd](args)
    finally:
        if tracing_device:
            import jax
            jax.profiler.stop_trace()
            if not args.quiet:
                print(f"device trace written to {args.trace_dir}")
    if args.profile:
        from pairwise_perturbation_tpu.utils import tracing
        print("\n" + tracing.report())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
