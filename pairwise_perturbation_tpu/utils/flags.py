"""Flag surface compatible with the reference drivers.

The reference parses single-dash long options with a hand-rolled scan
(getCmdOption, test_ALS.cxx:14-20). The full surface (SURVEY.md section 5):

-model -tensor -pp -update_percentage_pp -dim -size -rank -updaterank
-issparse -resprint -randomsvd -tol -pp_res_tol -lambda -magni -filename
-tensorfile -colmin -colmax -rationoise -timelimit -maxiter

plus additions: -dtype, -mesh, -seed, -checkpoint, -resume,
-device_loop, -layouts, -profile, -trace_dir.
Defaults and clamping follow test_ALS.cxx:64-196 / run.cxx:67-214.
"""

from __future__ import annotations

import argparse


def build_parser(prog: str = "pairwise_perturbation_tpu") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=__doc__)
    p.add_argument("-model", default="CP", choices=["CP", "Tucker"])
    p.add_argument("-tensor", default="p",
                   help="p | p2 | c | r | r2 | o1 (coil-100) | o2 (time-lapse)")
    p.add_argument("-pp", type=int, default=0,
                   help="legacy engine: 0 DT, 1 PP, 2 PP-partupdate; "
                        "run engine: 0 DT, 1 MSDT, 2 DT-LR, 3 MSDT-LR, 4 simple")
    p.add_argument("-update_percentage_pp", type=float, default=1.0)
    p.add_argument("-dim", type=int, default=8)
    p.add_argument("-size", type=int, default=10)
    p.add_argument("-rank", type=int, default=0, help="0 -> size//2")
    p.add_argument("-updaterank", type=int, default=1)
    p.add_argument("-randomsvd", type=int, default=0)
    p.add_argument("-issparse", type=int, default=0,
                   help="1: COO sparse engine (reference test_ALS.cxx:126-131). "
                        "Supported: test_als -model {CP,Tucker} -pp {0,1}, "
                        "run (all optimizers), and -mesh with sparse for "
                        "test_als CP/Tucker on a 1D nnz-sharded mesh; "
                        "anything else fails loudly")
    p.add_argument("-resprint", type=int, default=10)
    p.add_argument("-tol", type=float, default=1e-10,
                   help="relative tolerance; multiplied by ||V||")
    p.add_argument("-pp_res_tol", type=float, default=1e-2)
    p.add_argument("-lambda", dest="lam", type=float, default=0.0)
    p.add_argument("-magni", type=float, default=1.0,
                   help="PP damping ratio_step")
    p.add_argument("-filename", default="out.csv")
    p.add_argument("-tensorfile", default="test")
    p.add_argument("-colmin", type=float, default=0.5)
    p.add_argument("-colmax", type=float, default=0.9)
    p.add_argument("-rationoise", type=float, default=0.01)
    p.add_argument("-timelimit", type=float, default=5e3)
    p.add_argument("-maxiter", type=int, default=250)
    # additions to the reference surface
    p.add_argument("-dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("-mesh", default="", help="e.g. '4' or '2x4' device mesh")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-checkpoint", default="",
                   help="path prefix for factor checkpoints")
    p.add_argument("-resume", default="",
                   help="checkpoint path to resume factors from")
    p.add_argument("-device_loop", type=int, default=0,
                   help="1: run DT/PP phases fully on device "
                        "(lax.while_loop; one host sync per phase); "
                        "2: fully-fused machine (one dispatch per ~64 "
                        "sweeps; DT sweeps, cache builds, PP sweeps and "
                        "restarts all inside a single while_loop)")
    p.add_argument("-tucker_subspace", type=int, default=-1,
                   help="Tucker factor extraction: -1 = auto (default: "
                        "warm-started subspace iteration for large eigh "
                        "sides, exact otherwise), 0 = always exact "
                        "(reference semantics), >0 = that many subspace "
                        "iterations (~5x faster extraction; inexact, "
                        "self-correcting across sweeps)")
    p.add_argument("-tucker_pp_skip", type=float, default=0.0,
                   help="Tucker PP quiet-mode extraction skip (opt-in; "
                        "default 0 = off, reference semantics): a mode "
                        "whose other factors all drifted < this fraction "
                        "of pp_res_tol since the cache build keeps its "
                        "factor without recomputing the corrected TTMc "
                        "or the eigh. Measured NEGATIVE on coil "
                        "(stalls PP's compounding progress, "
                        "results/TUCKER_PP.md)")
    p.add_argument("-msdt_min_holdout", type=int, default=0,
                   help="MSDT(-LR): restrict the hold-out rotation to "
                        "modes of size >= this (0 = reference semantics). "
                        "Skewed tensors: skipping tiny hold-outs avoids "
                        "|V|*R/s_m-sized intermediates")
    p.add_argument("-planner", type=int, default=1,
                   help="1 (default): binary-tree root split chosen by the "
                        "native FLOP planner (native/planner.cpp) — e.g. "
                        "~20%% fewer sweep FLOPs on coil-100's skewed "
                        "shape; 0: reference midpoint split")
    p.add_argument("-layouts", type=int, default=0,
                   help="1: keep mode-minor permuted copies of V so "
                        "first-level contractions avoid XLA transposes")
    p.add_argument("-quiet", action="store_true")
    p.add_argument("-profile", type=int, default=0,
                   help="1: per-phase host timer scopes (synchronized "
                        "dispatch; adds overhead) + tracing report at "
                        "exit — the CTF Timer_epoch equivalent")
    p.add_argument("-trace_dir", default="",
                   help="with -profile: also write a jax.profiler device "
                        "trace (view with xprof/tensorboard)")
    return p


def clamp(args) -> None:
    """Range clamping as in test_ALS.cxx:76-196."""
    if args.rank <= 0:
        args.rank = max(args.size // 2, 1)
    args.pp = max(args.pp, 0)
    if not (0.0 < args.update_percentage_pp <= 1.0):
        args.update_percentage_pp = 1.0
    if args.maxiter < 0:
        args.maxiter = 5000
    if args.timelimit < 0:
        args.timelimit = 5e3
    if not (0 <= args.tol <= 1):
        args.tol = 1e-10
    if not (0 <= args.pp_res_tol <= 1):
        args.pp_res_tol = 1e-2
    if args.lam < 0:
        args.lam = 0.0
    if args.magni < 0:
        args.magni = 1.0
