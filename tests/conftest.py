"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with a virtual 8-device
mesh and float64 enabled, so that the conformance goldens (quoted to
~1e-10 by the reference test suite) match exactly.  Tests marked ``gpu``
need an NVIDIA GPU: the ``gpu`` fixture skips them elsewhere.  On the
card, ``python -m pytest tests -m gpu`` runs them (chip_smoke.py does).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_enable_x64", True)

from linearham_tpu.utils.runtime import enable_persistent_cache  # noqa: E402

# CPU compiles of the fused phylo step take a while; cache them across
# runs where every other entry point caches them.
enable_persistent_cache()

import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session", autouse=True)
def _ensure_fixtures():
    if not (FIXTURES / "simple_hmm_input.yaml").exists():
        subprocess.run(
            [sys.executable, str(FIXTURES / "make_fixtures.py")], check=True
        )


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX's default device is not
    a GPU (decided here, at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest tests -m gpu)")
    return dev
