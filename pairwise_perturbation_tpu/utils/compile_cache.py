"""Where the persistent XLA compilation cache lives.

A set ``JAX_COMPILATION_CACHE_DIR`` is left to JAX, which reads it itself.
Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed path, since
the path is part of the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Sets nothing when the variable is set."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
