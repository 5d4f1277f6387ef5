"""Artifact and cache locations inside the checkout (gitignored `artifacts/`).

Layout: <dir>/<name>.bin + <name>.json (index artifacts, index/build.py),
plus derived caches (gplanes_<sha>.v1.bin, index/device.py), block
checkpoints (scripts/build_big.py) and the XLA compile cache (jaxcache/).
"""
from __future__ import annotations

import os

_REPO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts")


def artifacts_dir() -> str:
    """Directory for writing at-scale artifacts (BTBS_ARTIFACTS overrides)."""
    d = os.environ.get("BTBS_ARTIFACTS", _REPO_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def find_artifact(name: str) -> str | None:
    """Prefix (no extension) of `<name>.json` in artifacts_dir(), or None."""
    prefix = os.path.join(os.environ.get("BTBS_ARTIFACTS", _REPO_DIR), name)
    return prefix if os.path.exists(prefix + ".json") else None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and wins;
    otherwise the cache lives at the fixed path <checkout>/artifacts/jaxcache
    (a fixed path, because the directory is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    d = os.path.join(_REPO_DIR, "jaxcache")
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    return d
