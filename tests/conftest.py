"""Test configuration: a virtual 8-device CPU mesh and 64-bit floats.

Must run before any backend initialization in the test process.  The
persistent compilation cache is the package's own (cnf2freq_tpu/
__init__.py): JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ in
the checkout.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


DEMO_DIR = "/root/reference"


@pytest.fixture(scope="session")
def demo_pedigree():
    from cnf2freq_tpu.io import load_plantimpute
    return load_plantimpute(f"{DEMO_DIR}/demoplantimpute.map",
                            f"{DEMO_DIR}/demoplantimpute.ped",
                            f"{DEMO_DIR}/demoplantimpute.gen")
