"""Energy- and space-dependent absorption — extensions of
ScatterDeleteStep (the reference's absorption is constant-coefficient,
physicl/light.py:131-260): ``pcoll = A * A_fn(E) * n(r) * |dr|``.

Pins: per-energy-bin survival against the analytic (1-p)^k law on both
execution paths, callable/string-expression equality for A_fn, the
variable-n atmosphere against the exact step-product, option validation,
and fused-path retention.
"""

import jax
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def _survival(fuse, steps=20, nphot=40000, seed=3, **kw):
    """Two energy populations through an absorbing medium; returns the
    per-energy survival fractions."""
    dt = 0.001
    s = phys.Simulation(until_t=steps * dt, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(**kw))
    s.add_photons(light.generate_photon_state(nphot, E=1.0))
    s.add_photons(light.generate_photon_state(nphot, E=2.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    E = np.asarray(s.sim_state.E)
    alive = np.asarray(s.sim_state.alive)
    return ((alive & (E == np.float32(1.0))).sum() / nphot,
            (alive & (E == np.float32(2.0))).sum() / nphot)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_energy_dependent_survival(fuse):
    """A_fn = E^-3 (photoelectric-like): the E=2 population sees 1/8 the
    cross-section; both survival fractions match (1 - p(E))^k."""
    dt, steps = 0.001, 20
    base = 0.05 / (float(light.c) * dt)   # p = 5%/step at E = 1
    s1, s2 = _survival(fuse, steps=steps, n=1.0, A=base,
                       A_fn=lambda E: E ** -3.0)
    exp1 = (1 - 0.05) ** steps
    exp2 = (1 - 0.05 / 8) ** steps
    assert np.isclose(s1, exp1, atol=0.01), (s1, exp1)
    assert np.isclose(s2, exp2, atol=0.01), (s2, exp2)


def test_a_fn_string_expression_matches_callable():
    """The reference-grammar string over E[gid] compiles to the same
    physics as the callable form (same seed -> identical draws)."""
    kw = dict(n=1.0, A=0.03 / (float(light.c) * 0.001))
    s_call = _survival("auto", seed=11, A_fn=lambda E: E ** -3.0, **kw)
    s_expr = _survival("auto", seed=11, A_fn="pow(E[gid], -3.0)", **kw)
    assert s_call == s_expr


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_variable_n_atmosphere_absorption(fuse):
    """Exponential atmosphere n(r) = exp(-x/L): deterministic +x
    trajectories make the survival an exact product over the visited
    densities — compare against the f64 host evaluation."""
    dt, steps, n = 0.001, 30, 60000
    L = 100.0e3
    A = 0.2 / (float(light.c) * dt)   # 20%/step at n=1
    s = phys.Simulation(until_t=steps * dt, seed=5, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        n=123.0,  # must be IGNORED when variable_n is on (family rule)
        A=A, variable_n=True,
        variable_n_fn=f"exp(-r0[gid] / {L})"))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    alive = np.asarray(s.sim_state.alive)[:n]
    # photon position before step k's kinematics: x_k = k * c * dt
    c_dt = float(light.c) * dt
    xk = (np.arange(steps, dtype=np.float64) + 1.0) * c_dt
    p = A * np.exp(-(xk) / L) * c_dt
    expect = np.prod(1.0 - p)
    assert np.isclose(alive.mean(), expect, atol=0.01), \
        (alive.mean(), expect)


def test_combined_a_fn_variable_n_stays_fused():
    s = phys.Simulation(until_t=0.003, seed=1)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        n=1.0, A=1e-3, A_fn=lambda E: E ** -2.0,
        variable_n=True, variable_n_fn="exp(-r0[gid] / 1e9)"))
    s.add_photons(light.generate_photon_state(4096, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.ts) == 3


def test_a_fn_option_validation():
    with pytest.raises(ValueError, match="unknown symbol"):
        light.ScatterDeleteStep(n=1.0, A=1.0, A_fn="sigma(E[gid])")
    with pytest.raises(ValueError, match="variable_n"):
        light.ScatterDeleteStep(n=1.0, A=1.0, variable_n=True)


def test_plain_delete_unchanged():
    """The constant-coefficient reference form still hits the analytic
    decay (regression guard for the routing change)."""
    dt, steps = 0.001, 10
    A = 0.3 / (float(light.c) * dt)
    s1, s2 = _survival("auto", steps=steps, n=1.0, A=A)
    expect = (1 - 0.3) ** steps
    assert np.isclose(s1, expect, atol=0.01)
    assert np.isclose(s2, expect, atol=0.01)
