"""Process set-up shared by the benchmark, the smoke check and the examples:
the persistent compile cache, the device check and the card's identity."""

from __future__ import annotations

import os
import subprocess

import jax

#: Compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is not set: one
#: fixed directory inside the checkout (listed in .gitignore), so a later
#: run of the same program finds its compiled executables again.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself),
    else :data:`CACHE_DIR`.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def cpu_rehearsal() -> bool:
    """True when the caller pinned JAX to the CPU (``JAX_PLATFORMS=cpu``):
    a rehearsal at small sizes, never a measurement."""
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def require_gpu() -> dict:
    """The default device's identity; raises unless it is a GPU or the
    caller asked for a CPU rehearsal."""
    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}
    if d.platform != "gpu" and not cpu_rehearsal():
        raise RuntimeError(
            "no GPU: JAX's default platform is %r (%d device(s)); set JAX_PLATFORMS=cpu "
            "to rehearse on the CPU" % (d.platform, info["count"])
        )
    return info


def card_identity() -> str:
    """``nvidia-smi``'s name and power limit of each card, read by a child
    process that does not touch JAX; "not available" without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else "not available"
