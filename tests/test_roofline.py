"""Hardware-utilization model (utils/roofline.py, VERDICT r3 weak #3).

The per-iteration flops+bytes model is derived by tracing the fused
pipeline's own iteration body to a jaxpr, so it tracks the kernels as
they evolve; these tests pin the counter against hand-countable plans.
"""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light
from physicl_tpu.ops.pipeline import try_build_fused
from physicl_tpu.state import SimState
from physicl_tpu.utils.roofline import (
    PEAKS, iteration_cost, roofline_report)


def _plan_for(steps_list, n=131072):
    sim = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0,
                          chunk_steps=1024)
    for i, s in enumerate(steps_list):
        sim.add_step(i, s)
    sim.add_photons(light.generate_photon_state(n, E=1.0))
    state = SimState.from_population([], sim._pending_bulk)
    steps = sim._ordered_steps()
    for s in steps:
        s.setup(sim)
    provider = try_build_fused(sim, steps, state)
    assert provider is not None
    return provider.plan, state.capacity


def test_kinematics_only_count_is_tiny():
    """Update+kinematics alone: dr = v*dt (3 mul), r += dr (3 add) plus
    per-iteration bookkeeping (alive tally) — the model must land within
    a small constant of the hand count, far below any scatter plan."""
    plan, cap = _plan_for([
        phys.UpdateTimeStep(lambda s: np.double(0.001)),
        physicl_tpu.newton.NewtonianKinematicsStep(),
    ])
    cost = iteration_cost(plan, cap)
    assert 6 <= cost["vpu_ops_per_particle"] <= 20
    assert cost["prng_draw_elems"] == 0
    assert cost["transcendentals"] == 0


def test_isotropic_plan_counts_and_bytes():
    plan, cap = _plan_for([
        phys.UpdateTimeStep(lambda s: np.double(0.001)),
        physicl_tpu.newton.NewtonianKinematicsStep(),
        light.ScatterIsotropicStep(A=np.double(0.001), n=np.double(0.001)),
        light.ScatterSignMeasureStep(None, True),
    ])
    cost = iteration_cost(plan, cap)
    # measured envelope of the iso+sign kernel body (fast_trig polynomials,
    # packed angles => 2 uniforms/photon): if this drifts by >2x the
    # kernel gained/lost real work and RESULTS.md needs re-deriving
    assert 50 <= cost["vpu_ops_per_particle"] <= 200
    assert cost["prng_draw_elems"] == 2 * cap  # u + packed angle pair
    assert cost["transcendentals"] == 0        # fast_trig: no libm calls
    # state crosses HBM exactly twice per chunk
    nf = 15
    assert cost["hbm_bytes_per_chunk"] >= 2 * nf * cap * 4
    assert cost["hbm_bytes_per_chunk"] < 2 * nf * cap * 4 * 1.5


def test_roofline_report_positions_rate():
    plan, cap = _plan_for([
        phys.UpdateTimeStep(lambda s: np.double(0.001)),
        physicl_tpu.newton.NewtonianKinematicsStep(),
        light.ScatterIsotropicStep(A=np.double(0.001), n=np.double(0.001)),
    ])
    rate = 4.5e10 / 1e7 * cap  # headline-equivalent iterations/s
    rep = roofline_report(plan, cap, rate, device=None)
    assert rep["flops_per_photon_step"] > 10
    assert rep["model_vpu_ops_per_s"] == pytest.approx(
        rep["flops_per_photon_step"] * rate, rel=0.01)
    # CPU test env: no peak entry -> utils are None, never a guessed roof
    if rep["vpu_util"] is not None:
        assert 0 < rep["vpu_util"] < 2.0


def test_vpu_peak_table_sane():
    """Every peak entry is a plausible GPU roof; a device kind without an
    entry reports no peaks (utilizations None), never a guessed roof."""
    from physicl_tpu.utils.roofline import device_peaks

    for kind, (ops, mem) in PEAKS.items():
        assert 1e12 < ops < 1e15
        assert 1e11 < mem < 1e13

    class _Dev:
        device_kind = "unlisted accelerator"

    assert device_peaks(_Dev()) is None


def test_compton_plan_counts_without_crashing():
    """Compton-family plans draw uniforms through the full _Rng surface
    and their unrolled Kahn chain is counted in full (r4 code-review
    findings #1/#3)."""
    plan, cap = _plan_for([
        phys.UpdateTimeStep(lambda s: np.double(0.001)),
        physicl_tpu.newton.NewtonianKinematicsStep(),
        light.ScatterComptonStep(A=np.double(0.001), n=np.double(0.001),
                                 mec2=0.5, kn_cross_section=True),
    ])
    cost = iteration_cost(plan, cap)
    # 12 Kahn tries x 2 draws (packed pair) + u + phi + ...
    assert cost["prng_draw_elems"] >= 24 * cap
    assert cost["vpu_ops_per_particle"] > 200   # KN chain >> iso's 101
    assert cost["uncounted_loop_bodies"] == 0   # body is loop-free
    rep = roofline_report(plan, cap, 3e9 / 1e7 * cap, device=None)
    assert rep["flops_per_photon_step"] == pytest.approx(
        cost["vpu_ops_per_particle"], rel=0.01)
