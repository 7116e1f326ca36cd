#!/usr/bin/env python
"""Experiment-suite generator — replacement for the reference's
SLURM script generators (script/script_{synthetic,real,strongscaling,
weakscaling}.py).

Emits bash scripts of CLI invocations. Scaling suites size the problem with
the reference's laws (size = 32 * n^(1/6), rank = 4 * n^(1/6) for dim-6;
size = 13 * n^(1/8) for dim-8 Poisson, script_synthetic.py:43-64) where
``n`` counts GPUs instead of CPU nodes; multi-GPU lines carry the
``-mesh`` flag so V is sharded over the cards.

Usage:
    python scripts/gen_experiments.py synthetic --hosts 1 4
    python scripts/gen_experiments.py real --hosts 1
    python scripts/gen_experiments.py strongscaling --hosts 1 2 4
    python scripts/gen_experiments.py weakscaling --hosts 1 4 16
"""

from __future__ import annotations

import argparse
import os

EXE = "python -m pairwise_perturbation_tpu.cli"


def _mesh_flag(chips: int) -> str:
    return f" -mesh {chips}" if chips > 1 else ""


def synthetic(hosts, chips_per_host, out_dir):
    for n in hosts:
        chips = n * chips_per_host
        lines = ["#!/bin/bash", "set -e", ""]
        size = int(32 * n ** (1. / 6))
        rank = int(4 * n ** (1. / 6))
        for tensor in ("r", "c"):
            lines.append(f"{EXE} test_als -model CP -tensor {tensor} -pp 0 "
                         f"-dim 6 -size {size} -rank {rank} -maxiter 250 "
                         f"-resprint 10{_mesh_flag(chips)} "
                         f"-filename CP_{tensor}_hosts={n}_pp=0.csv")
            for tol in (0.01, 0.05, 0.005):
                lines.append(
                    f"{EXE} test_als -model CP -tensor {tensor} -pp 1 "
                    f"-dim 6 -size {size} -rank {rank} -maxiter 250 "
                    f"-pp_res_tol {tol} -resprint 10{_mesh_flag(chips)} "
                    f"-filename CP_{tensor}_hosts={n}_pp=1_restol={tol}.csv")
        psize = int(13 * n ** (1. / 8))
        lines.append(f"{EXE} test_als -model CP -tensor p -pp 0 -dim 8 "
                     f"-size {psize} -rank 2 -maxiter 250 -resprint 10"
                     f"{_mesh_flag(chips)} -filename CP_p_hosts={n}_pp=0.csv")
        for tol in (0.01, 0.05, 0.005):
            lines.append(f"{EXE} test_als -model CP -tensor p -pp 1 -dim 8 "
                         f"-size {psize} -rank 2 -maxiter 250 -pp_res_tol {tol} "
                         f"-resprint 10{_mesh_flag(chips)} "
                         f"-filename CP_p_hosts={n}_pp=1_restol={tol}.csv")
        _write(out_dir, f"run_synthetic_hosts{n}.sh", lines)


def real(hosts, chips_per_host, out_dir):
    for n in hosts:
        chips = n * chips_per_host
        lines = ["#!/bin/bash", "set -e", ""]
        for t in ("o1", "o2"):
            lines.append(f"{EXE} test_als -model CP -tensor {t} -pp 0 -dim 4 "
                         f"-rank 10 -maxiter 250 -resprint 10{_mesh_flag(chips)} "
                         f"-filename CP_{t}_hosts={n}_pp=0_rank=10.csv")
            for tol in (0.05, 0.1):
                lines.append(
                    f"{EXE} test_als -model CP -tensor {t} -pp 1 -dim 4 "
                    f"-rank 10 -maxiter 250 -pp_res_tol {tol} -resprint 10"
                    f"{_mesh_flag(chips)} "
                    f"-filename CP_{t}_hosts={n}_pp=1_rank=10_restol={tol}.csv")
            lines.append(f"{EXE} test_als -model Tucker -tensor {t} -pp 0 "
                         f"-dim 4 -maxiter 250 -resprint 1{_mesh_flag(chips)} "
                         f"-filename Tucker_{t}_hosts={n}_pp=0.csv")
            for tol in (0.5, 0.1):
                lines.append(
                    f"{EXE} test_als -model Tucker -tensor {t} -pp 1 -dim 4 "
                    f"-maxiter 250 -pp_res_tol {tol} -resprint 1"
                    f"{_mesh_flag(chips)} "
                    f"-filename Tucker_{t}_hosts={n}_pp=1_restol={tol}.csv")
        _write(out_dir, f"run_real_hosts{n}.sh", lines)


def strongscaling(hosts, chips_per_host, out_dir, reps=5):
    for n in hosts:
        chips = n * chips_per_host
        lines = ["#!/bin/bash", "set -e", ""]
        for _ in range(reps):
            lines.append(f"{EXE} pp_bench -model CP -tensor r -dim 6 -size 50 "
                         f"-rank 6 -maxiter 5 -resprint 1{_mesh_flag(chips)} "
                         f"-filename bench_CP_r_hosts={n}.csv")
            lines.append(f"{EXE} pp_bench -model Tucker -tensor r2 -dim 6 "
                         f"-size 50 -rank 6 -maxiter 5 -resprint 1"
                         f"{_mesh_flag(chips)} "
                         f"-filename bench_Tucker_r2_hosts={n}.csv")
        _write(out_dir, f"run_strongscaling_hosts{n}.sh", lines)


def weakscaling(hosts, chips_per_host, out_dir):
    for n in hosts:
        chips = n * chips_per_host
        size = int(32 * n ** (1. / 6))
        rank = int(4 * n ** (1. / 6))
        lines = ["#!/bin/bash", "set -e", ""]
        lines.append(f"{EXE} pp_bench -model CP -tensor r -dim 6 -size {size} "
                     f"-rank {rank} -maxiter 5 -resprint 1{_mesh_flag(chips)} "
                     f"-filename bench_CP_r_weak_hosts={n}.csv")
        lines.append(f"{EXE} pp_bench -model Tucker -tensor r2 -dim 6 "
                     f"-size {size} -rank {rank} -maxiter 5 -resprint 1"
                     f"{_mesh_flag(chips)} "
                     f"-filename bench_Tucker_r2_weak_hosts={n}.csv")
        _write(out_dir, f"run_weakscaling_hosts{n}.sh", lines)


def _write(out_dir, name, lines):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.chmod(path, 0o755)
    print(f"wrote {path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("suite", choices=["synthetic", "real", "strongscaling",
                                     "weakscaling"])
    p.add_argument("--hosts", type=int, nargs="+", default=[1])
    p.add_argument("--chips-per-host", type=int, default=4)
    p.add_argument("--out", default="experiments")
    a = p.parse_args()
    fn = {"synthetic": synthetic, "real": real,
          "strongscaling": strongscaling, "weakscaling": weakscaling}[a.suite]
    fn(a.hosts, a.chips_per_host, a.out)


if __name__ == "__main__":
    main()
