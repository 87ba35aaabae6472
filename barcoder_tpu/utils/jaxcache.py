"""Persistent XLA compilation cache.

The scan engines compile once per (L, K, P, capacity) configuration;
caching the compiled executables on disk makes every CLI invocation after
the first start hot.

Where: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself,
and no other directory is set here); otherwise one fixed directory inside
the checkout, ``.jax_cache/`` (the path is part of nothing else, so it
never moves between runs of one checkout).

The cache is enabled on the GPU only: XLA:CPU persistent entries are
compiled for the exact host CPU ("machine features") and loading them on a
different machine warns or crashes, so CPU runs (tests, dryrun_multichip)
always compile fresh.

Set BARCODER_TPU_NO_CACHE=1 to disable.
"""

from __future__ import annotations

import os

_enabled = False

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The persistent cache directory: the environment's, or the fixed
    in-checkout one."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> None:
    global _enabled
    if _enabled or os.environ.get("BARCODER_TPU_NO_CACHE"):
        return
    import jax

    from .platform import device_platform

    _enabled = True  # decided for this process; don't re-probe
    if device_platform() != "gpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    # persist sub-second compiles too: a CLI process compiles a handful of
    # small executables (device prep, compaction) that would otherwise
    # recompile in every fresh process
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.15)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
