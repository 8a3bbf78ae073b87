"""Compton scattering (Klein-Nishina) — extension tests.

The reference has no energy-changing interaction (its photons keep E forever,
physicl/light.py:262-359); ScatterComptonStep adds exact Klein-Nishina
angular sampling (Kahn's rejection method below alpha = 1+sqrt(3),
Koblinger's direct method above) with the physical recoil shift
E' = E / (1 + alpha (1 - cos theta)). These tests pin:

* the sampled cos(theta) distribution against the bin-integrated analytic
  KN differential cross-section (chi^2 over 40 bins) in BOTH sampling
  regimes and at the regime boundary;
* the exact energy-angle consistency E' = E/(1 + alpha(1-cos)) on both
  execution paths (the defining kinematic relation);
* the Compton edge E'/E >= 1/(1+2 alpha);
* the Thomson limit (alpha -> 0: no energy shift, dipole-free isotropic-ish
  Thomson angular law with <cos^2> = 2/5);
* the closed-form sigma_KN/sigma_T total cross-section ratio against a
  float64 host evaluation (including the series/exact switch);
* collision-rate scaling under kn_cross_section=True on both paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light
from physicl_tpu.light import _kn_cos_eta, _kn_sigma_ratio


def _kn_pdf(cos, a):
    """Unnormalized Klein-Nishina differential cross-section per unit cos."""
    k = 1.0 + a * (1.0 - cos)
    return (1.0 / k**2) * (k + 1.0 / k - 1.0 + cos**2)


def _kn_bin_probs(a, edges):
    """Exact bin probabilities by dense trapezoidal integration."""
    grid = np.linspace(-1.0, 1.0, 200001)
    pdf = _kn_pdf(grid, a)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5
                                           * np.diff(grid))])
    cdf /= cdf[-1]
    at = np.interp(edges, grid, cdf)
    return np.diff(at)


def _sample_kn(a, n, tries=16, seed=0):
    u = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), (3 * tries, n),
                           jnp.float32))
    triples = [(jnp.asarray(u[3 * i]), jnp.asarray(u[3 * i + 1]),
                jnp.asarray(u[3 * i + 2])) for i in range(tries)]
    cos, eta, ok = _kn_cos_eta(jnp.full((n,), a, jnp.float32), triples,
                               jnp.float32)
    return np.asarray(cos), np.asarray(eta), np.asarray(ok)


@pytest.mark.parametrize("a", [0.05, 1.0, 2.0, 2.8, 50.0])
def test_kn_sampler_matches_analytic_distribution(a):
    """chi^2 of the sampled cos(theta) histogram vs the bin-integrated
    analytic KN distribution ~ 1 per dof; covers the Kahn regime
    (a < 1+sqrt(3)), the Koblinger regime, and the switch point."""
    n = 400000
    cos, eta, ok = _sample_kn(a, n, seed=int(a * 10))
    assert ok.mean() > 0.999
    cos = cos[ok]
    cnt, edges = np.histogram(cos, bins=40, range=(-1, 1))
    p = _kn_bin_probs(a, edges)
    exp = p * len(cos)
    z = (cnt - exp) / np.sqrt(np.maximum(exp, 1.0))
    chi2_dof = float((z**2).sum() / len(z))
    assert chi2_dof < 2.0, (a, chi2_dof, np.abs(z).max())
    assert np.abs(z).max() < 5.0, (a, np.abs(z).max())
    # eta is consistent with cos on every accepted lane (f32 rounding)
    np.testing.assert_allclose(eta[ok], 1.0 + a * (1.0 - cos), atol=3e-5,
                               rtol=3e-6)


def _one_compton(alpha, fuse, n=50000, seed=5, kn=False, A=1.0,
                 until_t=0.001):
    s = phys.Simulation(until_t=until_t, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=A, n=1.0, mec2=1.0 / alpha,
                                           kn_cross_section=kn))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    v = np.asarray(s.sim_state.v)[:, :n]
    E = np.asarray(s.sim_state.E)[:n]
    return v, E


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("alpha", [0.5, 10.0])
def test_compton_energy_angle_consistency(fuse, alpha):
    """E' = E / (1 + alpha (1 - cos theta)) holds exactly (f32 rounding)
    between the stored energy and the actual outgoing direction — the
    kinematic relation that ties the sampled eta to the frame rotation."""
    v, E = _one_compton(alpha, fuse)
    ct = v[0] / float(light.c)  # incoming beam was +x
    scat = E != np.float32(1.0)
    assert scat.mean() > 0.99  # pcoll = c*dt >> 1, Kahn residual ~1e-4
    pred = 1.0 / (1.0 + alpha * (1.0 - ct[scat]))
    np.testing.assert_allclose(E[scat], pred, atol=2e-5, rtol=2e-5)
    # Compton edge: backscatter energy bounded below
    edge = 1.0 / (1.0 + 2.0 * alpha)
    assert E.min() >= edge - 1e-6
    assert E.max() <= 1.0 + 1e-6
    # photons stay photons: |v| == c through the rotation
    speed = np.sqrt((v[:, scat] ** 2).sum(axis=0))
    np.testing.assert_allclose(speed, float(light.c), rtol=2e-5)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.slow
def test_compton_thomson_limit(fuse):
    """alpha -> 0: Klein-Nishina reduces to Thomson — the dipole
    (3/8)(1+cos^2) angular law (<cos^2> = 2/5, <cos> = 0) with no
    measurable energy shift."""
    v, E = _one_compton(1e-4, fuse, n=50000)
    ct = v[0] / float(light.c)
    moved = np.abs(ct) < 1.0 - 1e-7  # scatter identified via direction
    assert moved.mean() > 0.99
    cos = ct[moved]
    n_s = len(cos)
    assert abs(cos.mean()) < 5.0 / np.sqrt(n_s) + 0.01
    assert abs((cos**2).mean() - 0.4) < 5.0 * 0.29 / np.sqrt(n_s) + 0.005
    np.testing.assert_allclose(E, 1.0, atol=3e-4)


def test_kn_sigma_ratio_accuracy():
    """f32 closed form + small-alpha series vs float64 host evaluation:
    relative error < 2e-3 across 8 decades, continuous at the switch."""
    def host(a):
        a = np.asarray(a, np.float64)
        b = 1.0 + 2.0 * a
        l = np.log1p(2.0 * a)
        return 0.75 * ((1.0 + a) / a**3 * (2.0 * a * (1.0 + a) / b - l)
                       + l / (2.0 * a) - (1.0 + 3.0 * a) / b**2)

    grid = np.logspace(-4, 4, 300)
    got = np.asarray(_kn_sigma_ratio(jnp.asarray(grid, jnp.float32),
                                     jnp.float32), np.float64)
    rel = np.abs(got - host(grid)) / host(grid)
    assert rel.max() < 2e-3, rel.max()
    # continuity across the series/exact switch at alpha = 0.01
    lo = float(_kn_sigma_ratio(jnp.float32(0.00999), jnp.float32))
    hi = float(_kn_sigma_ratio(jnp.float32(0.01001), jnp.float32))
    assert abs(lo - hi) < 1e-4
    # limits: Thomson at alpha->0, strong suppression at high alpha
    assert abs(float(_kn_sigma_ratio(jnp.float32(1e-6), jnp.float32)) - 1.0) \
        < 1e-4
    assert float(_kn_sigma_ratio(jnp.float32(100.0), jnp.float32)) < 0.04


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.slow
def test_kn_cross_section_scales_collision_rate(fuse):
    """kn_cross_section=True multiplies pcoll by sigma_KN/sigma_T —
    at alpha=2 the scatter fraction drops to 0.3141x the Thomson rate."""
    base = 0.3
    A = base / (float(light.c) * 0.001)
    v, E = _one_compton(2.0, fuse, n=100000, kn=True, A=A, seed=9)
    frac = (E != np.float32(1.0)).mean()
    expect = base * 0.31411520
    assert np.isclose(frac, expect, rtol=0.08), (frac, expect)


@pytest.mark.slow
def test_compton_untouched_lanes_bitwise():
    """A=0: no collisions — E and v come back bitwise identical."""
    s = phys.Simulation(until_t=0.002, seed=2)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=0.0, n=1.0, mec2=0.5))
    st = light.generate_photon_state(4096, E=1.0)
    s.add_photons(st)
    s.start(); s.join()
    assert s.used_fused
    E = np.asarray(s.sim_state.E)[:4096]
    v = np.asarray(s.sim_state.v)[:, :4096]
    assert (E == np.float32(1.0)).all()
    assert (v[0] == np.float32(float(light.c))).all()
    assert (v[1] == 0).all() and (v[2] == 0).all()


def test_compton_option_validation():
    with pytest.raises(ValueError, match="kn_cross_section"):
        light.ScatterComptonStep(wavelength_dep_scattering=True)
    with pytest.raises(ValueError, match="kn_max_tries"):
        light.ScatterComptonStep(kn_max_tries=0)
    with pytest.raises(ValueError, match="mec2"):
        light.ScatterComptonStep(mec2=-1.0).setup(None)
    # typos / unsupported family options must fail loudly, not silently
    # run wrong physics (the HG family's kwargs.get() would swallow them)
    with pytest.raises(ValueError, match="kn_cross_sections"):
        light.ScatterComptonStep(kn_cross_sections=True)
    with pytest.raises(ValueError, match="A_fn"):
        light.ScatterComptonStep(A_fn=lambda E: E)
    with pytest.raises(ValueError, match="anisotropy"):
        light.ScatterComptonStep(g=0.5)


def test_koblinger_x3_piece_cancellation_free():
    """The 1/x^3 inverse CDF must track the f64 value for u near 1 at
    large alpha: the naive 1 - u*(1 - 1/b^2) loses the 1/b^2 term to f32
    rounding for b > ~4096 and caps the sampled tail at eta ~ 4096."""
    a = 5000.0
    b = 1.0 + 2.0 * a
    # f64 mirror of the Koblinger weights to aim u_pick at the w3 window
    inv_a1 = 1.0 / a
    log_b = np.log(b)
    w1 = (1.0 - 2.0 * inv_a1 - 2.0 * inv_a1**2) * log_b
    w2 = (2.0 * inv_a1 + inv_a1**2) * (2.0 * a / b)
    w3 = 0.5 * (1.0 - 1.0 / b**2)
    w4 = inv_a1**2 * 2.0 * a
    u_pick = (w1 + w2 + 0.5 * w3) / (w1 + w2 + w3 + w4)
    for u in (1.0 - 2.0**-23, 1.0 - 2.0**-22, 1.0 - 2.0**-20):
        triples = [(jnp.full((8,), u_pick, jnp.float32),
                    jnp.full((8,), u, jnp.float32),
                    jnp.zeros((8,), jnp.float32))]
        cos, eta, ok = _kn_cos_eta(jnp.full((8,), a, jnp.float32), triples,
                                   jnp.float32)
        expect = 1.0 / np.sqrt((1.0 - u) + u / b**2)
        np.testing.assert_allclose(np.asarray(eta), expect, rtol=5e-3)
        assert np.asarray(ok).all()
        # the kinematic ceiling is still respected
        assert (np.asarray(eta) <= b * (1 + 1e-4)).all()


def test_compton_default_mec2_is_physical():
    """With no mec2 override, alpha = E / (m_e c^2) in current code units:
    511 keV photons have alpha == 1."""
    step = light.ScatterComptonStep()
    step.setup(None)
    mec2_si = 9.1093837015e-31 * 299792458.0**2
    assert np.isclose(1.0 / step._inv_mec2, mec2_si, rtol=1e-9)
    E_511keV = 511.0e3 * 1.602176634e-19
    assert np.isclose(E_511keV * step._inv_mec2, 1.0, rtol=1e-3)


@pytest.mark.slow
def test_compton_variable_n_fuses():
    """The family's variable-density option composes with Compton and
    stays on the fused path."""
    s = phys.Simulation(until_t=0.003, seed=1)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(
        A=1e-3, n=1.0, mec2=1.0, variable_n=True,
        variable_n_fn="exp(-r0[gid] / 1e9)"))
    s.add_photons(light.generate_photon_state(4096, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.ts) == 3


@pytest.mark.parametrize("alpha", [0.5, 5.0])
@pytest.mark.slow
def test_compton_fused_generic_statistical_parity(alpha):
    """Different PRNG streams, same distribution: mean scattering cosine
    and mean outgoing energy agree between the Pallas kernel and the
    generic scan within sampling error."""
    res = {}
    for fuse in ("auto", "off"):
        v, E = _one_compton(alpha, fuse, n=100000, seed=11)
        ct = v[0] / float(light.c)
        scat = E != np.float32(1.0)
        res[fuse] = (ct[scat].mean(), E[scat].mean(), scat.mean())
    for i, tol in ((0, 0.01), (1, 0.005), (2, 0.002)):
        assert abs(res["auto"][i] - res["off"][i]) < tol, (i, res)


@pytest.mark.slow
def test_compton_multiple_scatters_degrade_energy():
    """Over many iterations every photon random-walks DOWN in energy
    (monotone non-increasing E is the physical signature of Compton
    cooling on free electrons at rest)."""
    s = phys.Simulation(until_t=0.050, seed=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    # pcoll ~ 0.5/step at alpha0 = 2
    s.add_step(2, light.ScatterComptonStep(
        A=0.5 / (float(light.c) * 0.001), n=1.0, mec2=0.5))
    s.add_photons(light.generate_photon_state(20000, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    E = np.asarray(s.sim_state.E)[:20000]
    assert (E <= 1.0 + 1e-6).all()
    # after ~50 steps at ~0.5 collisions/step, essentially everything has
    # scattered several times; the mean energy must have dropped hard
    assert E.mean() < 0.35, E.mean()
    assert (E < 0.999).mean() > 0.999


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.slow
def test_compton_heating_energy_conservation(fuse):
    """measure_deposition on Compton: photons never die, so the heating
    tally closes the energy budget EXACTLY per realization —
    sum(w*E)_initial == sum(w*E)_final + cumulative deposition."""
    c = float(light.c)
    mec2 = 2.0  # E/mec2 = 0.5: strong recoil
    s = phys.Simulation(until_t=0.012, seed=3, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    comp = light.ScatterComptonStep(
        A=np.double(0.25 / (c * 1e-3)), n=np.double(1.0), mec2=mec2,
        measure_deposition=True)
    s.add_step(2, comp)
    s.add_photons(light.generate_photon_state(40_000, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    E = np.asarray(s.sim_state.E, np.float64)[:40_000]
    dep = np.array(comp.data, dtype=float)
    assert dep.shape[0] == len(s.ts)
    budget = E.sum() + dep[:, 1].sum()
    np.testing.assert_allclose(budget, 40_000.0, rtol=1e-5)
    assert dep[:, 1].min() > 0  # cold electrons only absorb energy


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.slow
def test_thermal_compton_heating_signed(fuse):
    """Thermal Comptonization of COLD photons (alpha << 4 theta_e): the
    net 'heating' is negative — electrons pump the photons (inverse
    Compton) — and the budget still closes exactly."""
    c = float(light.c)
    theta_e = 0.02
    mec2 = 1000.0  # alpha = 1e-3 << 4 theta_e = 0.08
    s = phys.Simulation(until_t=0.012, seed=5, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    comp = light.ScatterComptonStep(
        A=np.double(0.3 / (c * 1e-3)), n=np.double(1.0), mec2=mec2,
        theta_e=theta_e, measure_deposition=True)
    s.add_step(2, comp)
    s.add_photons(light.generate_photon_state(40_000, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    E = np.asarray(s.sim_state.E, np.float64)[:40_000]
    dep = np.array(comp.data, dtype=float)[:, 1]
    np.testing.assert_allclose(E.sum() + dep.sum(), 40_000.0, rtol=1e-4)
    assert dep.sum() < 0  # net inverse-Compton gain for cold photons


def test_compton_heating_on_mesh_psums_globally():
    """The heating channel crosses shards as one psum: the budget closes
    on the full global population."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from physicl_tpu.parallel import make_mesh
    c = float(light.c)
    n = 131072
    s = phys.Simulation(until_t=0.008, seed=2, mesh=make_mesh(),
                        capacity=n)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    comp = light.ScatterComptonStep(
        A=np.double(0.25 / (c * 1e-3)), n=np.double(1.0), mec2=2.0,
        measure_deposition=True)
    s.add_step(2, comp)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    E = np.asarray(jax.device_get(s.sim_state.E), np.float64)[:n]
    dep = np.array(comp.data, dtype=float)[:, 1].sum()
    np.testing.assert_allclose(E.sum() + dep, float(n), rtol=1e-5)


def test_fast_log2_exp2_vs_f64_oracle():
    """The kernel's polynomial log2/exp2 (exponent-field extraction +
    degree-8/5 mantissa fits, ops/fused) against f64 libm across the
    whole f32 normal range each is used on: log2 on (2^-126, 2^127),
    exp2 on (-20, 20) — covering b = 1+2*alpha to alpha 1e4 and the
    Koblinger b^u power."""
    import jax.numpy as jnp

    from physicl_tpu.ops.fused import _fast_exp2, _fast_log2

    rng = np.random.default_rng(5)
    x = np.concatenate([
        2.0 ** rng.uniform(-126, 127, 4096),
        np.array([1.0, 1.0 - 2**-24, 1.0 + 2**-23, 2.0, 0.5, 3.0]),
    ]).astype(np.float32)
    got = np.asarray(_fast_log2(jnp.asarray(x)), np.float64)
    np.testing.assert_allclose(got, np.log2(x.astype(np.float64)),
                               atol=3e-6)
    y = np.concatenate([
        rng.uniform(-20, 20, 4096),
        np.array([0.0, 1.0, -1.0, 0.999999, 14.3, -0.7, 0.7]),
    ]).astype(np.float32)
    got = np.asarray(_fast_exp2(jnp.asarray(y)), np.float64)
    np.testing.assert_allclose(got, 2.0 ** y.astype(np.float64),
                               rtol=3e-7)


def test_kn_sigma_ratio_fast_matches_pin():
    """fast=True sigma_KN/sigma_T (polynomial log2) keeps the same 2e-5
    f64-oracle pin as the libm form across alpha in [1e-4, 1e4]."""
    import jax.numpy as jnp

    from physicl_tpu.light import _kn_sigma_ratio

    from mpmath import mp, mpf

    mp.dps = 40
    a = np.logspace(-4, 4, 801)
    # the f64 closed form itself cancels below alpha ~2e-4 (verified:
    # 1.7e-5 off at 1e-4) — the oracle must be extended precision
    exact = np.array([float(
        0.75 * ((1 + mpf(x)) / mpf(x) ** 3
                * (2 * mpf(x) * (1 + mpf(x)) / (1 + 2 * mpf(x))
                   - mp.log(1 + 2 * mpf(x)))
                + mp.log(1 + 2 * mpf(x)) / (2 * mpf(x))
                - (1 + 3 * mpf(x)) / (1 + 2 * mpf(x)) ** 2))
        for x in a])
    got = np.asarray(_kn_sigma_ratio(jnp.asarray(a, jnp.float32),
                                     jnp.float32, fast=True), np.float64)
    np.testing.assert_allclose(got, exact, rtol=2e-5)


def test_rayleigh_cos_theta_fast_matches_exact():
    """fast=True Cardano cube root (2^(log2/3)) against the libm form:
    agreement at the polynomial error (~2e-6), preserving the exact
    <cos^2> = 2/5 defining property."""
    import jax.numpy as jnp

    from physicl_tpu.light import _rayleigh_cos_theta

    u = np.linspace(1e-7, 1.0 - 1e-7, 200_001).astype(np.float32)
    fast = np.asarray(_rayleigh_cos_theta(jnp.asarray(u), jnp.float32,
                                          fast=True), np.float64)
    exact = np.asarray(_rayleigh_cos_theta(jnp.asarray(u), jnp.float32),
                       np.float64)
    np.testing.assert_allclose(fast, exact, atol=1e-5)
    assert abs((fast ** 2).mean() - 0.4) < 1e-3
