"""On-card checks of the GPU kernels (marker ``gpu``).

The test process is held to the CPU (conftest), so each check runs in a
child process with the default backend; it skips when that backend is not
a GPU.  On a machine with a card: ``python -m pytest tests/ -m gpu``.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KERNELS = r"""
import jax, jax.numpy as jnp, numpy as np
from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.hmm.family import gather_family
from cnf2freq_tpu.ops import scan_v2 as v2
from cnf2freq_tpu.utils import simulate_f2

ped = simulate_f2(n_f2=100, n_markers=24, seed=4)
for ind in ped.inds[1:]:
    ped.fixtrees(ind.n)
ped.count_descendants()
fb = gather_family(ped, ped.dous, 0, 23, dtype=np.float32).map(jnp.asarray)
dists = jnp.asarray(np.diff(ped.markerposes).astype(np.float32))
cfg, params = ModelConfig(), RuntimeParams()
st = v2.prep_slots(fb, jnp.float32)
e = v2.emissions_v2(st, cfg, jnp.float32)
ref = v2.fb_scan_v2(e, dists, cfg, params)
got = jax.jit(lambda e, d: v2.fb_sweeps_v2_triton(e, d, cfg, params))(
    e, dists)
for name in ref._fields:
    np.testing.assert_allclose(np.asarray(getattr(got, name)),
                               np.asarray(getattr(ref, name)),
                               rtol=1e-4, atol=1e-4, err_msg=name)
print("ok")
"""


@pytest.fixture
def gpu_env():
    """Environment for a child process on the default backend; skips
    unless that backend is a GPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs a GPU (JAX's default backend here: "
                    f"{probe.stdout.strip() or 'none'})")
    return env


@pytest.mark.gpu
def test_triton_sweeps_on_card(gpu_env):
    """The sweep kernel, compiled for the card, agrees with its XLA form
    in float32."""
    out = subprocess.run([sys.executable, "-c", KERNELS], env=gpu_env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
