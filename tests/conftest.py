"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the host
platform and splitting it into 8 virtual devices (SURVEY.md §4c). The
override goes through jax.config before any backend is initialized.

Card-only tests carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them unless JAX's default backend is a GPU. To run
them on a machine with a card, leave the platform to JAX:

    HAMMLET_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import os

_ON_GPU = os.environ.get("HAMMLET_TESTS_ON_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# runtime invariant checks default ON in tests (hammlet_tpu.debug)
os.environ.setdefault("HAMMLET_DEBUG", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other backends)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX runs on anything else
    (decided here, at run time, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX's default backend is "
                    f"{jax.default_backend()!r}")
    return jax.devices()[0]


# ---- mmap budget ----------------------------------------------------------
# Every XLA:CPU executable holds several JIT code mappings, and one pytest
# process compiles thousands of programs across the suite; measured growth
# reaches the default vm.max_map_count (65530) near the end of the suite,
# at which point the NEXT compile dies with SIGSEGV/SIGABRT inside
# backend_compile_and_load (reproduced 6x, final sample 65102 maps). Raise
# the limit when permitted, and as a portable fallback drop jax's compiled
# program caches whenever this process nears the ceiling.

_MAP_LIMIT = 65530
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _fh:
        _MAP_LIMIT = int(_fh.read())
        if _MAP_LIMIT < 1_000_000:
            _fh.seek(0)
            _fh.write("1000000\n")
            _MAP_LIMIT = 1_000_000
except (OSError, ValueError):
    pass


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as fh:
            return sum(1 for _ in fh)
    except OSError:  # non-Linux: no map limit to manage
        return 0


@pytest.fixture(autouse=True)
def _bound_mmap_growth():
    yield
    if _n_maps() > int(_MAP_LIMIT * 0.7):
        jax.clear_caches()
