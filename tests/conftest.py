import os

import pytest

# Tests run on the CPU backend with a virtual 8-device mesh, so the
# multi-device sharding paths compile and execute without a card. Only
# JAX_PLATFORMS=cuda keeps the GPU: that is how the gpu-marked tests run
# on the card (`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`).
ON_CARD = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
# parallel test workers must not share one persistent compile cache
jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_ROOT = "/root/reference"


def reference_path(*parts):
    return os.path.join(REFERENCE_ROOT, *parts)


@pytest.fixture
def reference_dir():
    """The reference checkout's fixtures; skips when it is absent."""
    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip(f"reference fixtures not present at {REFERENCE_ROOT}")
    return REFERENCE_ROOT


@pytest.fixture
def gpu():
    """The GPU devices; skips unless JAX runs on a card."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
    return jax.devices()
