"""The one place that decides where device programs run and where their
compiled form is cached.

Routes ask `device_routes_enabled()` instead of probing JAX themselves:

* on a GPU backend the device routes are on, unless EVENTQL_TPU_DEVICE=0;
* on the CPU backend they are off, unless EVENTQL_TPU_DEVICE=1 (the tests
  run the device programs on XLA:CPU this way).

`require_gpu()` is for callers that asked for a device run (the chip smoke
test, the benchmark): it raises instead of carrying on on the CPU.

The persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says, or at `<repo>/.jax_cache/` when that variable is unset. It is
installed once per process, when the engine starts (Runtime, evqld).
"""

from __future__ import annotations

import os
import threading

DEVICE_ENV = "EVENTQL_TPU_DEVICE"
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

_install_lock = threading.Lock()


def platform() -> str:
    """JAX's default backend: 'gpu' or 'cpu'."""
    import jax

    return jax.default_backend()


def device_routes_enabled() -> bool:
    flag = os.environ.get(DEVICE_ENV)
    if flag == "1":
        return True
    if flag == "0":
        return False
    return platform() == "gpu"


def require_gpu():
    """The devices of a run that must happen on the card; raises when
    JAX found none (never falls back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"a GPU run was requested but JAX found {devices[0].platform} "
            "devices only"
        )
    return devices


def compile_cache_dir() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def install_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and no
    other path is set here. Idempotent; returns the directory."""
    import jax

    path = compile_cache_dir()
    with _install_lock:
        if not os.environ.get(CACHE_ENV) and (
            jax.config.jax_compilation_cache_dir != path
        ):
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
    return path
