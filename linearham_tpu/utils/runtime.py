"""Runtime configuration: on-disk caches and the per-platform policy.

The reference has no compilation step at all (ahead-of-time C++); here a
fresh process pays an XLA compile per (family-shape, chunk-size) bucket,
which can run to minutes at production shapes.  Every production entry
point (CLI, pipeline, workflow, bench) therefore enables JAX's persistent
compilation cache so the cost is paid once per machine, not once per run.

Platform policy: the one place that maps the JAX platform onto what it
selects.  The GPU runs the production configuration (f32, the CUDA pruning
kernel of ops/pruning_kernel.py); the CPU runs f64 through the jnp pruning
path, so the reference's golden log-likelihoods (quoted to ~1e-10) match.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

_CACHE_ENABLED = False

# Fixed, gitignored cache root inside the checkout (the JAX compile cache
# keys on nothing path-dependent, but a root that moves never hits).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache")


def cache_root() -> str:
    """Root of the program's own caches (executables, compiled families):
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``CHECKOUT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn on JAX's on-disk compilation cache (idempotent).

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache goes to
    ``CHECKOUT_CACHE_DIR/jax``.  Returns the directory in use.
    """
    global _CACHE_ENABLED
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if _CACHE_ENABLED:
        return cache_dir or jax.config.jax_compilation_cache_dir
    if not cache_dir:
        cache_dir = os.path.join(CHECKOUT_CACHE_DIR, "jax")
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Anything over a second is worth keeping; the fused phylo step
    # compiles in tens of seconds at production shapes.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _CACHE_ENABLED = True
    return cache_dir


@dataclass(frozen=True)
class PlatformPolicy:
    """What one JAX platform selects."""

    platform: str
    precision: str          # what --precision auto resolves to
    pruning_kernel: bool    # f32 pruning runs the CUDA kernel


_POLICIES = {
    "gpu": PlatformPolicy("gpu", "f32", True),
    "cpu": PlatformPolicy("cpu", "f64", False),
}


def platform_policy(platform: Optional[str] = None) -> PlatformPolicy:
    """The policy of ``platform`` (default: that of ``jax.devices()[0]``).

    Raises RuntimeError on a platform the program does not support.
    """
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    try:
        return _POLICIES[platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; linearham_tpu runs on "
            f"{', '.join(sorted(_POLICIES))}") from None


def use_pruning_kernel(dtype) -> bool:
    """True when pruning in ``dtype`` runs the CUDA kernel (f32 on GPU)."""
    import jax.numpy as jnp

    return platform_policy().pruning_kernel and \
        jnp.dtype(dtype) == jnp.float32


def resolve_dtype(precision: Optional[str] = None):
    """Map a --precision flag onto a jnp dtype.

    ``f32``/``f64`` are explicit; ``None``/``auto`` takes the platform
    policy's choice.  Requesting f64 enables the x64 mode it needs.
    """
    import jax
    import jax.numpy as jnp

    if precision in (None, "auto"):
        precision = platform_policy().precision
    if precision in ("f32", "float32"):
        return jnp.float32
    if precision in ("f64", "float64"):
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    raise ValueError(f"unknown precision {precision!r} "
                     "(expected f32, f64, or auto)")
