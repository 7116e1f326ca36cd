"""pairwise_perturbation_tpu — Pairwise Perturbation ALS in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
LinjianMa/pairwise-perturbation (CTF/MPI C++): alternating least squares for
CP and Tucker dense tensor decomposition, accelerated by dimension trees (DT),
multi-sweep dimension trees (MSDT), low-rank first-contraction updates (LR),
and pairwise perturbation (PP) with tolerance-triggered restarts.

Layer map (equivalents of the reference's layers, see SURVEY.md):

- ``ops``      — tensor-algebra primitives (MTTKRP, TTMc, Gram/S assembly,
                 residual identities, R x R solves, dimension trees).
                 Replaces common.cxx + CTF einsum machinery.
- ``models``   — CP and Tucker ALS solvers with DT/PP/MSDT/LR optimizer
                 policies. Replaces als_CP.cxx, als_Tucker.cxx and src/.
- ``parallel`` — jax.sharding device-mesh layer (replaces CTF's cyclic
                 block distribution + MPI collectives).
- ``utils``    — synthetic tensor zoo, binary dataset IO, CSV metrics with
                 the reference schema, checkpointing, flags.

Everything under ``jit`` is static-shape, compiler-friendly; the DT <-> PP
phase machine runs in host Python at per-sweep granularity.
"""

from pairwise_perturbation_tpu import config
from pairwise_perturbation_tpu.ops import contract, solve, dimtree

__version__ = "0.1.0"

__all__ = [
    "config",
    "contract",
    "solve",
    "dimtree",
]
