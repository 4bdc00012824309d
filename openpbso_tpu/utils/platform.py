"""Device selection and the compile cache, shared by every entry point.

``force_platform`` pins JAX to the platform a CLI asked for and fails
when that cannot hold: a run that asked for the GPU never goes on
quietly on the CPU, nor the other way round. ``enable_compile_cache``
gives every program one persistent XLA cache location.
"""
from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")
# jax_platforms names the CUDA plugin "cuda"; jax.default_backend() and
# Device.platform report it as "gpu"
_JAX_PLATFORM = {"cpu": "cpu", "gpu": "cuda"}

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def force_platform(name: str | None) -> None:
    """Pin JAX to ``name`` ("cpu" or "gpu"); no-op on None or empty.

    Before JAX has started a backend, this sets ``jax_platforms``, so a
    missing GPU then fails at first use instead of falling back. When a
    backend is already live it cannot be switched: a live backend other
    than ``name`` raises RuntimeError."""
    if not name:
        return
    if name not in PLATFORMS:
        raise ValueError(f"unknown platform {name!r}; have {PLATFORMS}")
    import jax
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        live = jax.default_backend()
        if live != name:
            raise RuntimeError(
                f"platform {name!r} requested, but JAX already runs on "
                f"{live!r}; choose the platform before JAX starts")
        return
    jax.config.update("jax_platforms", _JAX_PLATFORM[name])


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache is ``<checkout>/.jax_cache``:
    a fixed path, because the path is part of the cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
