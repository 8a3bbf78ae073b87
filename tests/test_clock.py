"""Long-run clock integrity (VERDICT r2 weak #3).

Device scalars are f32 (no x64): a bare on-device ``t += dt`` accumulates
O(n*eps) drift — measurably wrong at a few hundred thousand iterations
(plain f32 crosses t=0.25 with dt=1e-6 ~350 iterations late, and t=1.0
~9500 iterations EARLY). The engine therefore keeps the clock exact:

* generic path — ``UpdateTimeStep.apply`` uses Kahan-compensated f32
  summation (``SimState.t_comp``), keeping ``t`` within ~1 ulp of the
  exact sum;
* fused path — the host replays the SAME f32 Kahan arithmetic
  bit-for-bit (ops/pipeline.py:_host_schedule), so ``sim.ts`` stays
  byte-identical between paths. (A plain-f64 host replay was tried and
  rejected: exactness of the f64 sum is not the goal — agreement with
  the device clock is.)

Both must hit ``t >= T`` within 1 iteration of the exact f64 count
(reference keeps f64 ``sim.t`` on the host, physicl/__init__.py:341-343).
"""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

DT = 1e-6
T_END = 0.25


def _crossing_f64(dt: float) -> int:
    """Smallest n such that an exact f64 sum of n copies of dt >= T_END."""
    acc = np.add.accumulate(np.full(300_000, dt, np.float64))
    return int(np.argmax(acc >= T_END)) + 1


def _run(fuse: str):
    s = phys.Simulation(until_t=T_END, seed=0, chunk_steps=4096, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(8, E=1.0))
    s.start()
    s.join()
    return s


def test_fused_quarter_million_iterations_exact_exit():
    s = _run("auto")
    assert s.used_fused
    # the Kahan-compensated clock tracks the exact f64 crossing within 1
    expected = _crossing_f64(DT)
    assert expected == 250_000  # sanity on the arithmetic itself
    assert abs(len(s.ts) - expected) <= 1
    assert s.ts[-1] >= T_END - 1e-9


@pytest.mark.slow
def test_generic_quarter_million_iterations_kahan_clock():
    s = _run("off")
    assert not s.used_fused
    # the device quantizes dt to f32 each iteration; the exact count is the
    # f64 sum of that quantized dt (f32(1e-6) < 1e-6, so one extra step)
    expected = _crossing_f64(float(np.float32(DT)))
    # plain f32 accumulation would be ~350 iterations late here — the
    # Kahan-compensated clock must stay within 1
    assert abs(len(s.ts) - expected) <= 1
    assert s.ts[-1] >= T_END - 1e-6
