"""Global numeric configuration for the framework.

The reference computes everything in float64 (CTF ``Tensor<>`` = double).
The default compute dtype here is float32, which halves the memory traffic
of the bandwidth-bound contractions; float64 (``-dtype float64``) runs
natively on the GPU and reproduces the reference's precision. Every f32
matmul/einsum runs at ``Precision.HIGHEST``: on an NVIDIA GPU a
DEFAULT-precision f32 product may run in TF32 (about three decimal digits),
which the R x R Gram solves cannot tolerate. Tests run on CPU with x64
enabled and pass float64 explicitly to validate the algebra against the
reference semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


@dataclass
class NumericConfig:
    # Compute dtype for tensors/factors.
    dtype: object = jnp.float32
    # Matmul/einsum precision: HIGHEST (IEEE f32, never TF32) keeps the
    # R x R Gram solves stable in f32.
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST
    # Relative eigenvalue cutoff for pseudo-inverse solves. The reference
    # takes raw reciprocals of ScaLAPACK singular values (common.cxx:720-722);
    # a tiny relative cutoff is the f32-safe equivalent. ops/solve.py
    # additionally floors this at the dtype's eigenvalue noise level
    # (R * eps) so f32 never reciprocates eigh noise.
    rcond: float = 1e-12
    # Iterative-refinement passes for f32/bf16 R x R solves (f64 skips).
    # Restores backward stability of ill-conditioned solves — the f32
    # equivalent of the reference's f64 ScaLAPACK solves (ops/solve.py).
    solve_refine: int = 2


_cfg = NumericConfig()


def get() -> NumericConfig:
    return _cfg


def override(**kwargs):
    """Context manager temporarily overriding config fields.

    NOTE: jitted functions cache on traced Python state only through their
    arguments; functions that read the config at trace time must be
    re-jitted (or take the flag as a static argument) to observe changes.
    """
    from contextlib import contextmanager

    @contextmanager
    def _ctx():
        old = {k: getattr(_cfg, k) for k in kwargs}
        try:
            for k, v in kwargs.items():
                setattr(_cfg, k, v)
            yield _cfg
        finally:
            for k, v in old.items():
                setattr(_cfg, k, v)

    return _ctx()


def set_dtype(dtype) -> None:
    _cfg.dtype = dtype


def set_precision(precision) -> None:
    _cfg.precision = precision


def default_dtype():
    return _cfg.dtype


def default_precision():
    return _cfg.precision
