import os

# Tests run on CPU with a virtual 8-device mesh so sharding logic is
# exercised without a GPU. Must be set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import subprocess

import pytest

REFERENCE_TOOLS = pathlib.Path(
    "/root/reference/witch_msa/tools/magus/tools")
EXAMPLES = pathlib.Path("/root/reference/examples/data")


def _tool(name: str):
    for sub in ("hmmer", "fasttree", "mcl"):
        p = REFERENCE_TOOLS / sub / name
        if p.exists():
            return str(p)
    return None


@pytest.fixture(scope="session")
def hmmbuild_bin():
    p = _tool("hmmbuild")
    if p is None:
        pytest.skip("reference hmmbuild binary not available")
    return p


@pytest.fixture(scope="session")
def hmmsearch_bin():
    p = _tool("hmmsearch")
    if p is None:
        pytest.skip("reference hmmsearch binary not available")
    return p


@pytest.fixture(scope="session")
def hmmalign_bin():
    p = _tool("hmmalign")
    if p is None:
        pytest.skip("reference hmmalign binary not available")
    return p


@pytest.fixture(scope="session")
def example_data():
    if not EXAMPLES.exists():
        pytest.skip("reference example data not available")
    return EXAMPLES


@pytest.fixture
def gpu():
    """Skips a `gpu`-marked test unless JAX's backend is a GPU (decided
    here, at run time, never at import)."""
    from witch_tpu.device import on_gpu
    if not on_gpu():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it on the card")


def run(cmd, **kw):
    return subprocess.run(cmd, check=True, capture_output=True, **kw)
