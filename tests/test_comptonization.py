"""Thermal Comptonization (ScatterComptonStep(theta_e=...)) — extension.

Electrons drawn from a non-relativistic Maxwell distribution, collisions
weighted by the exact relativistic flux factor (1 - beta.n), exact KN in
the electron frame, exact Lorentz boosts. The physics pin is the
Kompaneets single-scatter energy drift <dE/E> = 4 theta_e - alpha:

* Thomson-limit GAIN of 4 theta_e for soft photons (inverse Compton);
* zero net drift at alpha = 4 theta_e;
* cooling dominated by recoil for hard photons;
* |v| stays exactly c, energies stay finite/positive;
* statistical parity between the fused Pallas kernel and the generic scan;
* T_e (Kelvin) <-> theta_e conversion and option validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def _one_thermal(alpha, theta_e, fuse="auto", n=300000, seed=5, p=0.3):
    """One iteration with UNSATURATED collision probability p (< 1 even at
    the head-on flux maximum): the relativistic rate factor (1 - beta.n)
    must be able to reweight which electrons scatter — a saturated
    pcoll >= 1 washes it out and biases the Kompaneets drift from
    4 theta_e down to ~3 theta_e. Returns (E'/E, cos, v)."""
    s = phys.Simulation(until_t=0.001, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=p / (float(light.c) * 0.001),
                                           n=1.0, mec2=1.0 / alpha,
                                           theta_e=theta_e))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    v = np.asarray(s.sim_state.v)[:, :n]
    E = np.asarray(s.sim_state.E)[:n]
    return E, v[0] / float(light.c), v


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.slow
def test_kompaneets_thomson_gain(fuse):
    """Soft photons (alpha -> 0) through hot electrons GAIN
    <dE/E> = 4 theta_e per scatter — the inverse-Compton / SZ signature
    (impossible with the reference's static-energy photons)."""
    theta_e = 0.01
    E, ct, v = _one_thermal(1e-9, theta_e, fuse=fuse)
    scat = E != np.float32(1.0)
    assert 0.25 < scat.mean() < 0.35
    gain = E[scat].mean() - 1.0
    assert abs(gain - 4 * theta_e) < 0.005, gain
    # energies are finite and positive, spread is Doppler-broadened
    assert np.isfinite(E).all() and (E > 0).all()
    assert E[scat].std() > 0.05  # ~sqrt(2 theta_e)-wide Doppler kernel


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_kompaneets_equilibrium_crossing(fuse):
    """At alpha = 4 theta_e the Doppler gain and the recoil loss cancel:
    the net drift is zero to O(theta^2)."""
    theta_e = 0.01
    E, ct, v = _one_thermal(4 * theta_e, theta_e, fuse=fuse, seed=9)
    scat = E != np.float32(1.0)
    drift = E[scat].mean() - 1.0
    assert abs(drift) < 0.008, drift


@pytest.mark.slow
def test_kompaneets_recoil_cooling():
    """Hard photons (alpha >> 4 theta_e) COOL: drift ~ 4 theta_e - alpha."""
    theta_e, alpha = 0.005, 0.1
    E, ct, v = _one_thermal(alpha, theta_e, seed=3)
    scat = E != np.float32(1.0)
    drift = E[scat].mean() - 1.0
    expect = 4 * theta_e - alpha
    assert drift < -0.03, drift
    assert abs(drift - expect) < 0.02, (drift, expect)


def test_thermal_speed_preserved():
    """|v| == c exactly through boost -> KN rotation -> boost back."""
    E, ct, v = _one_thermal(1.0, 0.02, n=50000, seed=7, p=0.9)
    scat = E != np.float32(1.0)
    speed = np.sqrt((v[:, scat] ** 2).sum(axis=0)) / float(light.c)
    np.testing.assert_allclose(speed, 1.0, rtol=3e-5)


@pytest.mark.slow
def test_thermal_fused_generic_parity():
    """Different PRNG streams, same distribution: mean gain, spread and
    scatter fraction agree between the Pallas kernel and the generic
    scan within sampling error."""
    res = {}
    for fuse in ("auto", "off"):
        E, ct, v = _one_thermal(1e-6, 0.02, fuse=fuse, n=100000, seed=11)
        scat = E != np.float32(1.0)
        res[fuse] = (E[scat].mean(), E[scat].std(), scat.mean())
    for i, tol in ((0, 0.004), (1, 0.01), (2, 0.01)):
        assert abs(res["auto"][i] - res["off"][i]) < tol, (i, res)


def test_theta_e_zero_takes_cold_path():
    """theta_e=0.0 must behave exactly like the electrons-at-rest sampler
    (the E'-angle relation is deterministic there, impossible with any
    thermal smearing)."""
    s = phys.Simulation(until_t=0.001, seed=5)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=1.0, n=1.0, mec2=2.0,
                                           theta_e=0.0))
    s.add_photons(light.generate_photon_state(20000, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    v = np.asarray(s.sim_state.v)[:, :20000]
    E = np.asarray(s.sim_state.E)[:20000]
    ct = v[0] / float(light.c)
    scat = E != np.float32(1.0)
    pred = 1.0 / (1.0 + 0.5 * (1.0 - ct[scat]))
    np.testing.assert_allclose(E[scat], pred, atol=3e-5, rtol=3e-5)


def test_Te_kelvin_conversion():
    """T_e in Kelvin maps to theta_e = kB T_e / (m_e c^2)."""
    step = light.ScatterComptonStep(T_e=5.93e7)
    step.setup(None)
    kB = 1.380649e-23
    mec2 = 9.1093837015e-31 * 299792458.0 ** 2
    assert np.isclose(step._theta_e, kB * 5.93e7 / mec2, rtol=1e-6)
    assert np.isclose(step._theta_e, 0.01, rtol=0.01)


def test_thermal_option_validation():
    with pytest.raises(ValueError, match="not both"):
        light.ScatterComptonStep(theta_e=0.01, T_e=1e7)
    with pytest.raises(ValueError, match="theta_e"):
        light.ScatterComptonStep(theta_e=0.5)
    with pytest.raises(ValueError, match="theta_e"):
        light.ScatterComptonStep(T_e=2.0e9).setup(None)
    # accepted-but-degraded range [0.05, 0.2] warns about the Maxwell clip
    with pytest.warns(RuntimeWarning, match="Maxwell"):
        light.ScatterComptonStep(theta_e=0.1)


@pytest.mark.slow
def test_comptonization_y_parameter():
    """Repeated scattering of soft photons off hot electrons amplifies the
    mean energy by e^y, y = 4 theta_e N_scatter (unsaturated regime) —
    the Comptonization y-parameter."""
    theta_e, steps = 0.02, 40
    dt = 0.001
    p = 0.5  # collisions per step
    s = phys.Simulation(until_t=steps * dt, seed=2)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(
        A=p / (float(light.c) * dt), n=1.0, mec2=1e9, theta_e=theta_e))
    s.add_photons(light.generate_photon_state(50000, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    E = np.asarray(s.sim_state.E)[:50000]
    y = 4 * theta_e * p * steps
    # mean amplification e^y (alpha stays << 4 theta_e throughout)
    assert np.isclose(np.log(E.mean()), y, atol=0.25 * y), \
        (np.log(E.mean()), y)


def test_fast_neg2log_vs_f64_oracle():
    """The fused kernel's Box-Muller radius (-2 ln u by exponent-field
    extraction + degree-8 mantissa polynomial, ops/fused._fast_neg2log)
    against the f64 libm form: uniformly accurate in ln across the whole
    f32 draw range, INCLUDING the deep Maxwell tail (u -> 2^-32 is a
    6.6-sigma electron; a truncated-series log would clip it)."""
    import jax.numpy as jnp

    from physicl_tpu.ops.fused import _fast_neg2log

    rng = np.random.default_rng(3)
    u = np.concatenate([
        rng.random(4096),
        2.0 ** -rng.uniform(0.0, 32.0, 2048),     # log-uniform deep tail
        np.array([1.0 - 2**-24, 0.5, 2.0**-32, 1e-12, 2.0**-126]),
    ]).astype(np.float32)
    u = u[u > 0]
    got = np.asarray(_fast_neg2log(jnp.asarray(u)), np.float64)
    want = -2.0 * np.log(u.astype(np.float64))
    # abs err in ln ~1.5e-6 (poly 2.1e-6 in log2 * ln2) => 3e-6 in -2 ln u,
    # plus f32 representation noise on the large-exponent end
    assert np.abs(got - want).max() < 1e-5 * np.maximum(want, 1.0).max()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=3e-6)


def test_gauss3_fast_matches_exact_moments():
    """fast_trig Box-Muller (polynomial sin/cos + extracted log) produces
    the same standard normals as the libm form to the documented wobble:
    per-sample agreement at the 1.1e-3 _fast_sinpi error times the radius,
    and distribution moments to statistical precision."""
    import jax.numpy as jnp

    from physicl_tpu.light import _gauss3_from_uniform

    rng = np.random.default_rng(11)
    u4 = tuple(jnp.asarray(rng.random(200_000, dtype=np.float32).clip(1e-9))
               for _ in range(4))
    fast = [np.asarray(g, np.float64)
            for g in _gauss3_from_uniform(u4, jnp.float32, fast_trig=True)]
    exact = [np.asarray(g, np.float64)
             for g in _gauss3_from_uniform(u4, jnp.float32)]
    for gf, ge in zip(fast, exact):
        # angle wobble scales with the radius; radii here reach ~6.4
        np.testing.assert_allclose(gf, ge, atol=1.3e-3 * 6.5)
        assert abs(gf.mean()) < 0.01
        assert abs(gf.std() - 1.0) < 0.005
