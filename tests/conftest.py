"""Test configuration: run everything on a virtual 8-device CPU mesh so
sharding paths can be exercised without accelerator hardware.

Tests marked ``gpu`` take the ``gpu`` fixture and skip unless JAX's
first device is a GPU.  Run them on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless the environment names the platforms (the gpu command above)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from bensolve_tpu import examples  # noqa: E402
from bensolve_tpu.lp import ensure_compile_cache  # noqa: E402

ensure_compile_cache()


@pytest.fixture(scope="session")
def ex_dir(tmp_path_factory):
    """The generated example suite as .vlp files (ex01..ex06, ex08,
    ex10, ex11), written once per test session."""
    return examples.write_suite(str(tmp_path_factory.mktemp("ex")))


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX's first device is not
    a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
    return dev
