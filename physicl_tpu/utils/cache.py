"""Persistent XLA compilation cache for fast cold starts.

Within one process the in-memory kernel cache (ops/fused.py) absorbs repeated
compiles, but every NEW process (scripts, notebook restarts, CI shards) pays
them again. JAX's persistent compilation cache stores serialized executables
on disk keyed by HLO + compiler version.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and this
module sets no other. Otherwise the engine points the cache at a fixed,
git-ignored directory inside the checkout (``<repo>/.jax_cache``): the path
is part of the cache key, so a directory that moves never hits. It does so
lazily, right before the first kernel/scan compile (constructing a
``Simulation`` has no process-global side effects), and not at all with
``PHYSICL_NO_COMPILE_CACHE=1``. The reference has no counterpart (pyopencl
caches kernel binaries per driver, physicl/__init__.py:583-597 recompiles
per process).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_compilation_cache() -> str | None:
    """Point JAX's persistent compilation cache at the in-checkout default
    unless ``JAX_COMPILATION_CACHE_DIR`` (or an earlier call) already set
    one. Returns the directory in effect, or None when caching is off."""
    import jax

    if os.environ.get("PHYSICL_NO_COMPILE_CACHE") == "1":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:  # JAX reads the variable itself
        return env
    if jax.default_backend() == "cpu":
        # CPU executables are AOT-compiled against the build host's exact
        # ISA features; a cache shared across machines can serve binaries
        # the current host can't run (XLA warns "could lead to SIGILL").
        # CPU compiles are cheap — cache only accelerator backends.
        return None
    current = jax.config.jax_compilation_cache_dir
    if current:  # the user (or a previous call) already configured one
        return current
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    except OSError:  # read-only checkout: run without a persistent cache
        return None
    return DEFAULT_DIR
