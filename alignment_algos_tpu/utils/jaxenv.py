"""Process-level JAX set-up shared by the CLIs, ``bench.py``,
``chip_smoke.py`` and the test suite.

``compile_cache_dir`` is the one rule for JAX's persistent compilation
cache: the directory ``JAX_COMPILATION_CACHE_DIR`` names when it is set,
otherwise ``<repo>/.jax_cache`` (a fixed path, listed in ``.gitignore``;
the path is part of the cache key, so it must not move between runs).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_jax() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and start a whole-process profiler trace when ``AAT_TRACE_DIR`` is
    set.  Call before the first compilation.  Returns the cache dir."""
    cache = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        import jax
        jax.config.update("jax_compilation_cache_dir", cache)
    _maybe_start_trace()
    return cache


def _maybe_start_trace() -> None:
    """Whole-process XLA profiler capture when AAT_TRACE_DIR is set
    (utils/profiling.py): trace starts here, stops at interpreter exit."""
    logdir = os.environ.get("AAT_TRACE_DIR")
    if not logdir:
        return
    import atexit
    import jax
    jax.profiler.start_trace(logdir)
    atexit.register(jax.profiler.stop_trace)
