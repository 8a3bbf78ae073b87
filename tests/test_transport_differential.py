"""Differential transport tests: our engine vs the REFERENCE's own physics.

The reference ships a pure-Python twin of every OpenCL kernel, selected by
``cl_on=False`` (physicl/light.py:207-223, 335-350) — its examples use that
path as the oracle (examples/runtime1.py). These tests import the ACTUAL
reference package (pyopencl stubbed out, same trick as
test_units_differential.py), run its Python transport on real ``Simulation``
threads, and compare observables against our engine on identical
configurations:

* kinematics: positions must agree EXACTLY (deterministic Euler);
* absorption: survival fractions agree within combined binomial error;
* isotropic scattering: the +x sign-balance relaxation trajectories agree.

RNG streams differ (host numpy vs the device's counter-based PRNG), so stochastic
comparisons are statistical — but both sides must also sit on the shared
analytic law, which catches one-sided bugs a two-sample test can absorb.
Skipped when the reference tree is absent. Population sizes are kept small:
the reference advances ~10^4 object-steps/s in pure Python.
"""

import os
import sys
import types

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

REF_PATH = "/root/reference"
DT = 1e-3


@pytest.fixture(scope="module")
def ref():
    if not os.path.isdir(REF_PATH):
        pytest.skip("reference tree not available")
    if "physicl" not in sys.modules:
        pycl = types.ModuleType("pyopencl")
        pycl.array = types.ModuleType("pyopencl.array")
        pycl.create_some_context = lambda *a, **k: None
        sys.modules.setdefault("pyopencl", pycl)
        sys.modules.setdefault("pyopencl.array", pycl.array)
        sys.path.insert(0, REF_PATH)
    import physicl  # noqa: F401
    import physicl.light  # noqa: F401
    import physicl.newton  # noqa: F401

    return sys.modules["physicl"]


def _ref_sim(ref, n_photons, k_iters, seed):
    np.random.seed(seed)  # the reference draws from global numpy RNG
    s = ref.Simulation(bounds=np.array([1e3] * 3), cl_on=False,
                       exit=lambda cond: cond.t >= k_iters * DT * 0.9999)
    for _ in range(n_photons):
        s.add_obj(ref.light.PhotonObject(
            s=np.array([0.0] * 3, dtype=np.double),
            v=np.array([ref.light.c, 0, 0], dtype=np.double),
            E=np.double(1)))
    s.add_step(0, ref.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, ref.newton.NewtonianKinematicsStep())
    return s


def _our_sim(n_photons, k_iters, seed):
    s = phys.Simulation(until_t=k_iters * DT * 0.9999, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(n_photons, E=1.0))
    return s


def test_kinematics_exact_parity(ref):
    """Euler positions after k steps are deterministic: both frameworks
    must land every photon at exactly r = c * dt * k * x_hat."""
    n, k = 50, 10
    rs = _ref_sim(ref, n, k, seed=0)
    rs.start(); rs.join()
    assert len(rs.ts) == k
    ref_r = np.array([np.asarray(o.r, np.float64) for o in rs.objects])

    s = _our_sim(n, k, seed=0)
    s.start(); s.join()
    assert len(s.ts) == k
    our_r = np.asarray(s.sim_state.r, np.float64)[:, :n].T

    np.testing.assert_allclose(our_r, ref_r, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        ref_r[:, 0], float(ref.light.c.view(np.ndarray)) * DT * k, rtol=1e-9)
    # the time logs agree too (reference keeps f64, ours replays f32 Kahan)
    np.testing.assert_allclose(np.asarray(rs.ts, np.float64),
                               np.asarray(s.ts, np.float64), rtol=1e-5)


def test_absorption_survival_parity(ref):
    """ScatterDeleteStep: per-step kill probability p = n*A*|dr| on both
    sides; survival fractions agree with each other AND the analytic
    (1-p)^k within binomial tolerance."""
    n_phot, k = 3000, 15
    p_step = 0.08
    c = float(ref.light.c.view(np.ndarray))
    A = np.double(p_step / (c * DT))

    # ScatterDeleteStepREFERENCE: the reference's only absorption step with
    # a Python twin (its CLProgram rewrite builds a kernel unconditionally,
    # physicl/light.py:254 — and its thread swallows the failure silently)
    rs = _ref_sim(ref, n_phot, k, seed=7)
    rs.add_step(2, ref.light.ScatterDeleteStepReference(np.double(1.0), A))
    rs.start(); rs.join()
    surv_ref = len(rs.objects) / n_phot

    s = _our_sim(n_phot, k, seed=7)
    s.add_step(2, light.ScatterDeleteStep(np.double(1.0), A))
    s.start(); s.join()
    surv_ours = int(np.asarray(s.sim_state.alive).sum()) / n_phot

    expect = (1 - p_step) ** k  # ~0.286
    sigma = np.sqrt(expect * (1 - expect) / n_phot)
    assert abs(surv_ref - expect) < 5 * sigma, (surv_ref, expect)
    assert abs(surv_ours - expect) < 5 * sigma, (surv_ours, expect)
    assert abs(surv_ref - surv_ours) < 7 * sigma


def test_isotropic_sign_relaxation_parity(ref):
    """ScatterIsotropicStep: the +x share decays 0.5 + 0.5*(1-p)^k on both
    sides (the reference's angle-uniform resampling convention, which our
    kernel reproduces)."""
    n_phot, k = 1500, 10
    p_step = 0.25
    c = float(ref.light.c.view(np.ndarray))
    A = np.double(p_step / (c * DT))

    rs = _ref_sim(ref, n_phot, k, seed=3)
    rs.add_step(2, ref.light.ScatterIsotropicStep(A=A, n=np.double(1.0)))
    ref_sign = ref.light.ScatterSignMeasureStep(None, True)
    rs.add_step(3, ref_sign)
    rs.start(); rs.join()
    ref_shares = np.array([r[2] / r[1] for r in ref_sign.data])

    s = _our_sim(n_phot, k, seed=3)
    s.add_step(2, light.ScatterIsotropicStep(A=A, n=np.double(1.0)))
    our_sign = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, our_sign)
    s.start(); s.join()
    our_shares = np.array([r[2] / r[1] for r in our_sign.data])

    kk = min(len(ref_shares), len(our_shares))
    expect = 0.5 + 0.5 * (1 - p_step) ** np.arange(1, kk + 1)
    sigma = np.sqrt(0.25 / n_phot)  # worst-case binomial share error
    assert np.abs(ref_shares[:kk] - expect).max() < 6 * sigma
    assert np.abs(our_shares[:kk] - expect).max() < 6 * sigma
    assert np.abs(ref_shares[:kk] - our_shares[:kk]).max() < 9 * sigma


@pytest.mark.slow
def test_wavelength_dependence_parity(ref):
    """lambda^-4 weighting: blue photons scatter ((E_b/E_r)^4)x more often
    than red on BOTH implementations (the reference folds (hc/E)^-4 into
    pcoll, physicl/light.py:341)."""
    n_phot, k = 1200, 8
    c = float(ref.light.c.view(np.ndarray))
    h = float(ref.light.h.view(np.ndarray))
    E_red = h * c / 700e-9
    E_blue = h * c / 500e-9  # (700/500)^4 = 3.84x the scatter rate
    # pcoll * lambda^-4 folding: pick A so the RED rate is ~0.04/step
    A = np.double(0.04 / (c * DT) / ((h * c) / E_red) ** -4)

    def ref_run(E):
        np.random.seed(11)
        s = ref.Simulation(bounds=np.array([1e3] * 3), cl_on=False,
                           exit=lambda cond: cond.t >= k * DT * 0.9999)
        for _ in range(n_phot):
            s.add_obj(ref.light.PhotonObject(
                s=np.array([0.0] * 3, dtype=np.double),
                v=np.array([ref.light.c, 0, 0], dtype=np.double),
                E=np.double(E)))
        s.add_step(0, ref.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, ref.newton.NewtonianKinematicsStep())
        s.add_step(2, ref.light.ScatterIsotropicStep(
            A=A, n=np.double(1.0), wavelength_dep_scattering=True))
        sign = ref.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, sign)
        s.start(); s.join()
        return np.array([r[2] / r[1] for r in sign.data])

    def our_run(E):
        s = phys.Simulation(until_t=k * DT * 0.9999, seed=11)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterIsotropicStep(
            A=A, n=np.double(1.0), wavelength_dep_scattering=True))
        sign = light.ScatterSignMeasureStep(None, True)
        s.add_step(3, sign)
        s.add_photons(light.generate_photon_state(n_phot, E=E))
        s.start(); s.join()
        return np.array([r[2] / r[1] for r in sign.data])

    sigma = np.sqrt(0.25 / n_phot)
    for E, rate in ((E_red, 0.04), (E_blue, 0.04 * (700 / 500) ** 4)):
        expect = 0.5 + 0.5 * (1 - rate) ** np.arange(1, k + 1)
        r_sh, o_sh = ref_run(E), our_run(E)
        kk = min(len(r_sh), len(o_sh), k)
        assert np.abs(r_sh[:kk] - expect[:kk]).max() < 6 * sigma, E
        assert np.abs(o_sh[:kk] - expect[:kk]).max() < 6 * sigma, E
        assert np.abs(r_sh[:kk] - o_sh[:kk]).max() < 9 * sigma, E
