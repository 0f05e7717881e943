"""Where JAX keeps its persistent compilation cache — one rule for every
entry point (the CLI, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``).

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: JAX reads the
variable itself and nothing here names another directory. Otherwise the
cache lives at ``<checkout>/.jax_cache/`` (listed in ``.gitignore``), a
fixed path, so that repeat runs from one checkout find what earlier runs
compiled.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at the directory the rule above
    picks, and cache every program, however quick its compile. Raises
    when the directory cannot be made. Returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    if path == CHECKOUT_CACHE_DIR:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
