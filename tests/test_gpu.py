"""Card-only checks: the Triton chunk kernel compiled for the GPU.

Run on a GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere the ``gpu`` fixture skips them. ``chip_smoke.py`` covers every op
family at full size.
"""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton as newton
from physicl_tpu.ops import families as FA
from physicl_tpu.ops import fused as F

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("kind", ["iso", "compton", "voxel_tri", "trace"])
def test_compiled_kernel_matches_xla_chunk(gpu, kind):
    plan = FA.family_plan(kind, chunk=64)
    args = FA.family_inputs(plan, 1 << 16) + (5, 64)
    ref = F._build_xla_chunk(plan, 1 << 16)(*args)
    got = F._build_triton_chunk(plan, 1 << 16)(*args)
    assert FA.compare_chunks(plan, ref, got)["ok"]


def test_simulation_runs_the_kernel(gpu):
    s = phys.Simulation(until_t=0.0095, seed=2, chunk_steps=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                             n=np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, meas)
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    assert "fused chunk builder: triton" in s.explain_plan()
    s.start(); s.join()
    assert s.used_fused and len(s.ts) == 10
    assert all(int(r[1]) == 100_000 for r in meas.data)
