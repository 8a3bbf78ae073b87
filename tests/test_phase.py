"""User-defined phase functions (ScatterPhaseFunctionStep): exact inverse
CDFs and tabulated phase tables, fused + generic (extension — the
reference's only angular redistribution is isotropic)."""

import jax.numpy as jnp
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

C = float(light.c)
DT = 1e-3


def _run(step, n=60_000, k=6, seed=0, fuse="auto", p_step=0.9):
    s = phys.Simulation(until_t=k * DT * 0.9999, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    v = np.asarray(s.sim_state.v, np.float64)[:, :n]
    return s, v


def _linear_icdf(a):
    """Exact inverse CDF of p(mu) = (1 + a*mu)/2 on [-1, 1]:
    CDF u = (mu+1)/2 + a(mu^2-1)/4 -> mu = (-1 + sqrt(1-a(2-a-4u)))/a."""
    def icdf(u):
        disc = 1.0 - a * (2.0 - a - 4.0 * u)
        return (jnp.sqrt(jnp.maximum(disc, 0.0)) - 1.0) / a
    return icdf


def test_exact_icdf_linear_phase_first_moment():
    """p(mu) = (1+a*mu)/2 has <mu> = a/3; single forced scatter from +x
    makes <vx>/c the sampled <cos theta>."""
    a = 0.6
    A = np.double(1.0 / (C * DT))  # pcoll = 1: every photon scatters
    step = light.ScatterPhaseFunctionStep(
        A=A, n=np.double(1.0), cos_theta_icdf=_linear_icdf(a))
    s, v = _run(step, k=1)
    assert s.used_fused
    mean_mu = (v[0] / np.linalg.norm(v, axis=0)).mean()
    assert abs(mean_mu - a / 3) < 5 / np.sqrt(v.shape[1])
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), C, rtol=3e-5)


def test_tabulated_rayleigh_matches_analytic_moment():
    """A (1+mu^2) phase TABLE reproduces the Rayleigh second moment
    <mu^2> = 2/5 through the gather-free piecewise-linear inverse CDF."""
    mu = np.linspace(-1, 1, 201)
    step = light.ScatterPhaseFunctionStep(
        A=np.double(1.0 / (C * DT)), n=np.double(1.0),
        phase_table=(mu, 1.0 + mu ** 2), table_bins=128)
    s, v = _run(step, k=1, seed=2)
    assert s.used_fused
    mu_s = v[0] / np.linalg.norm(v, axis=0)
    assert abs((mu_s ** 2).mean() - 0.4) < 0.01
    assert abs(mu_s.mean()) < 5 / np.sqrt(v.shape[1])  # symmetric table


def test_fused_generic_parity_statistical():
    a = -0.5
    A = np.double(0.5 / (C * DT))
    out = {}
    for fuse in ("auto", "off"):
        step = light.ScatterPhaseFunctionStep(
            A=A, n=np.double(1.0), cos_theta_icdf=_linear_icdf(a))
        s, v = _run(step, n=40_000, k=4, seed=5, fuse=fuse)
        assert s.used_fused == (fuse == "auto")
        out[fuse] = (v[0] / np.linalg.norm(v, axis=0)).mean()
    assert abs(out["auto"] - out["off"]) < 0.02


@pytest.mark.slow
def test_tabulated_forward_peak_matches_hg():
    """An HG phase table (g=0.7) through the tabulated route lands the HG
    first moment <mu> = g, cross-checking against the closed-form step."""
    g = 0.7
    mu = np.linspace(-1, 1, 2001)
    pdf = (1 - g * g) / (1 + g * g - 2 * g * mu) ** 1.5
    A = np.double(1.0 / (C * DT))  # pcoll = 1: every photon scatters
    s_t, v_t = _run(light.ScatterPhaseFunctionStep(
        A=A, n=np.double(1.0), phase_table=(mu, pdf), table_bins=256),
        k=1, seed=7)
    s_h, v_h = _run(light.ScatterHenyeyGreensteinStep(
        A=A, n=np.double(1.0), g=g), k=1, seed=7)
    mt = (v_t[0] / np.linalg.norm(v_t, axis=0)).mean()
    mh = (v_h[0] / np.linalg.norm(v_h, axis=0)).mean()
    assert abs(mh - g) < 0.01
    # table inversion error: O(bins^-2) + the pdf grid's own resolution
    assert abs(mt - mh) < 0.02


def test_validation_and_explain():
    with pytest.raises(ValueError, match="exactly one"):
        light.ScatterPhaseFunctionStep(A=1.0, n=1.0)
    with pytest.raises(ValueError, match="unknown option"):
        light.ScatterPhaseFunctionStep(cos_theta_icdf=lambda u: u, typo=1)
    with pytest.raises(TypeError):
        light.ScatterPhaseFunctionStep(cos_theta_icdf=0.5)
    with pytest.raises(ValueError, match="increasing"):
        light.ScatterPhaseFunctionStep(
            phase_table=(np.array([1.0, -1.0]), np.array([1.0, 1.0])))
    with pytest.raises(ValueError, match="nonnegative"):
        light.ScatterPhaseFunctionStep(
            phase_table=(np.array([-1.0, 1.0]), np.array([1.0, -2.0])))


def test_mie_rayleigh_limit():
    """x << 1 reduces to the dipole (1 + mu^2) shape with g ~ 0."""
    mu, pdf, g = light.mie_phase_table(0.01, 1.5)
    pdf_n = pdf / np.trapezoid(pdf, mu)
    dip = (3.0 / 8.0) * (1 + mu ** 2)
    assert np.abs(pdf_n - dip).max() / dip.max() < 1e-3
    assert abs(g) < 1e-3


def test_mie_asymmetry_self_consistency():
    """g from the Mie coefficient series (BH 4.63) equals the table's own
    first moment — requires a_n/b_n AND the angular sums to be right."""
    for x, m in ((0.5, 1.33), (3.0, 1.33), (10.0, 1.5 + 0.01j)):
        mu, pdf, g = light.mie_phase_table(x, m, n_mu=4001)
        g_tab = np.trapezoid(mu * pdf, mu) / np.trapezoid(pdf, mu)
        assert abs(g - g_tab) < 1e-3, (x, g, g_tab)


@pytest.mark.slow
def test_mie_table_transport_lands_g():
    """End to end: Mie table -> ScatterPhaseFunctionStep; the sampled
    <cos theta> after one forced scatter is the Mie asymmetry parameter."""
    mu, pdf, g = light.mie_phase_table(3.0, 1.33, n_mu=2001)
    step = light.ScatterPhaseFunctionStep(
        A=np.double(1.0 / (C * DT)), n=np.double(1.0),
        phase_table=(mu, pdf), table_bins=256)
    s, v = _run(step, n=80_000, k=1, seed=12)
    assert s.used_fused
    m_s = (v[0] / np.linalg.norm(v, axis=0)).mean()
    # forward peak: the 256-bin inversion carries most of the tolerance
    assert abs(m_s - g) < 0.02, (m_s, g)


def test_mie_validation():
    with pytest.raises(ValueError, match="positive"):
        light.mie_phase_table(0.0)
