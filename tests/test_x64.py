"""float64 state on the generic path (VERDICT round-1 weak item 7).

``jax_enable_x64`` is process-global, so the run happens in a subprocess.
The fused kernel is f32 by design; ``Simulation(dtype=f64)``
must work end-to-end on the generic scan and actually carry f64 precision.
"""

import pytest
import os
import subprocess
import sys

_SCRIPT = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[1])
import numpy as np
import pytest
import jax.numpy as jnp
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

s = phys.Simulation(exit=lambda c: c.t >= 0.005, seed=0, fuse="off",
                    dtype=jnp.float64)
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
meas = light.ScatterMeasureStep(None, True,
                                [[2.5 * float(light.c) * 1e-3, np.nan,
                                  np.nan]])
s.add_step(2, meas)
s.add_photons(light.generate_photon_state(100, E=1.0))
s.start(); s.join()
assert s.sim_state.r.dtype == jnp.float64, s.sim_state.r.dtype
assert s.sim_state.t.dtype == jnp.float64
# f64 carries the position exactly: r = 5 * c * dt to full precision
r = np.asarray(s.sim_state.r)[0, 0]
expect = 5 * 299792458.0 * 1e-3
assert abs(r - expect) < 1e-6, (r, expect)  # far below f32 resolution (~100)
counts = [int(row[2]) for row in meas.data]
assert counts == [0, 0, 100, 0, 0], counts

# round-3 features under f64: exponential transform + importance split
s = phys.Simulation(until_t=0.01 * 0.9999, seed=1, fuse="off",
                    dtype=jnp.float64, capacity=65536)
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
s.add_step(2, light.ScatterDeleteStep(
    np.double(1.0), np.double(0.1 / (299792458.0 * 1e-3)), stretch=0.8))
s.add_step(3, light.ImportanceSplitStep(
    lambda x, y, z: 2.0 ** jnp.floor(x / (4 * 299792458.0 * 1e-3) + 0.5),
    roulette=False))
s.add_photons(light.generate_photon_state(2000, E=1.0))
s.start(); s.join()
w = np.asarray(s.sim_state.w, np.float64)
alive = np.asarray(s.sim_state.alive)
assert s.sim_state.w.dtype == jnp.float64
# mu=1 beam: per-photon weight law in f64, split factors exact
k = len(s.ts)
wl = ((1 - 0.1) / (1 - 0.1 * 0.2)) ** k
ws = np.unique(np.round(np.log2(w[alive] / wl)))
assert np.allclose(ws, np.round(ws)), ws  # weights = wl / 2^splits exactly
exp_w = 2000 * (1 - 0.1) ** k
assert abs(w[alive].sum() - exp_w) / exp_w < 0.05
print("X64 OK")
"""


@pytest.mark.slow
def test_f64_generic_path():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", _SCRIPT, repo],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "X64 OK" in out.stdout
