"""Device checks and run-time setup shared by the entry points.

``cli.main``, ``bench.py`` and ``chip_smoke.py`` call
:func:`enable_compile_cache`; the measuring scripts call
:func:`require_gpu` so that a run without the card fails instead of
timing the CPU backend under a device metric's name.
"""

from __future__ import annotations

import os
import subprocess

#: The checkout this package runs from; the compile cache lives under it.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(backend: str) -> str | None:
    """Directory this program sets for JAX's persistent compilation cache,
    or None where it sets none.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone.  Otherwise accelerator runs cache under the checkout: the
    path is part of the cache key, so it must not move between runs.  The
    CPU backend gets no cache: its compiles are cheap, and the installed
    jaxlib warns on every reload of a CPU entry that the compiling host's
    CPU features differ from the running host's and may fault (SIGILL).
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or backend == "cpu":
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir`; returns the directory JAX will use."""
    import jax

    cache_dir = compile_cache_dir(jax.default_backend())
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return jax.config.jax_compilation_cache_dir


def require_gpu():
    """Return ``jax.devices()``; raise SystemExit when JAX's default
    backend is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"error: needs a GPU; JAX's default backend is "
            f"{devices[0].platform!r} ({devices[0].device_kind})")
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it, for every printed result."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
