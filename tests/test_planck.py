"""Planck-spectrum generation tests (reference: physicl/light.py:53-128,
examples/planck_distribution.ipynb parity)."""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light


def test_planck_distribution_normalized():
    """The density integrates to ~1 over (0, inf) (it is a normalized
    distribution by construction: 15/pi^4 * integral x^3 e^-x = 90/pi^4*...).

    The reference's Wien form integrates to 15/pi^4 * 6 = 90/pi^4 ~ 0.9239 of
    the true Planck normalization — we match the reference exactly.
    """
    T = 5778.0
    val, err = light.planck_probability(0.0, 1e-16, T)
    assert np.isclose(val, 90 / np.pi ** 4, rtol=1e-6)


def test_planck_probability_matches_quad():
    """Closed-form integral agrees with scipy quad on the same density."""
    import scipy.integrate

    T = 5778.0
    a, b = 1e-20, 5e-19
    analytic, _ = light.planck_probability(a, b, T)
    quad = light.planck_probability(
        a, b, T,
        integrator=lambda fn, lo, hi: scipy.integrate.quad(
            lambda x: float(fn(x).value()), lo, hi),
    )
    assert np.isclose(analytic, quad[0], rtol=1e-8)


def test_planck_density_shape():
    """Density peaks at x = 3 (d/dx x^3 e^-x = 0 at x=3), i.e. E = 3 kB T."""
    T = 5778.0
    kT = float(light.kB.value()) * T
    E = np.linspace(0.1 * kT, 10 * kT, 2000)
    d = np.array([float(light.planck_distribution(e, T).value()) for e in E])
    assert np.isclose(E[np.argmax(d)], 3 * kT, rtol=0.01)


def test_planck_sampling_histogram_parity():
    """Sampled energies reproduce the analytic curve (vectorized sampler)."""
    T = 5778.0
    kT = float(light.kB.value()) * T
    a, b = 0.1 * kT, 12 * kT
    E = light.planck_sample_E(200_000, a, b, T, bins=2000, seed=0)
    hist, edges = np.histogram(E, bins=40, range=(a, b), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    analytic = np.array(
        [float(light.planck_distribution(x, T).value()) for x in centers])
    # normalize analytic over the sampled window
    analytic /= np.trapezoid(analytic, centers)
    mask = analytic > 0.05 * analytic.max()
    rel = np.abs(hist[mask] - analytic[mask]) / analytic[mask]
    assert rel.max() < 0.10


def test_planck_phot_distribution_memoized_and_valid():
    T = 5778.0
    a, b = 1e-20, 5e-19
    light._planck_cache.clear()
    xs = [light.planck_phot_distribution(a, b, T, bins=500) for _ in range(200)]
    assert len(light._planck_cache) == 1  # memoized across calls
    vals = np.array([float(x.value()) for x in xs])
    # never returns None (fixed reference quirk) and stays in range
    assert np.all(vals >= a) and np.all(vals <= b)
    assert xs[0].units == {"M": 1, "L": 2, "T": -2}


def test_generate_photons_and_from_E():
    ph = light.generate_photons(100, min=1.0, max=2.0)
    assert len(ph) == 100
    Es = np.array([float(p.E) for p in ph])
    assert np.all((Es >= 1.0) & (Es <= 2.0))
    # default sampler is power(3): mean of U^(1/3)-ish distribution = 3/4
    assert np.isclose(Es.mean(), 1.75, atol=0.05)

    ph2 = light.generate_photons_from_E([phys.Measurement(1, "J**1"),
                                         phys.Measurement(2, "J**1")])
    assert len(ph2) == 2
    assert float(np.linalg.norm(np.asarray(ph2[0].v, np.double))) == float(light.c)


def test_generate_photons_legacy_scalar_fn():
    ph = light.generate_photons(10, fn=lambda: 0.5, min=0.0, max=2.0)
    assert np.allclose([float(p.E) for p in ph], 1.0)


def test_E_wavelength_roundtrip():
    lam = phys.Measurement(550e-9, "m**1")
    E = light.E_from_wavelength(lam)
    back = light.wavelength_from_E(E)
    assert np.isclose(float(back), 550e-9, rtol=1e-12)


def test_planck_kernel_and_poly_samplers_agree():
    """All device sampling methods share the polynomial: quantiles agree."""
    import jax

    T = 5778.0
    kT = float(light.kB.value()) * T
    a, b = 0.1 * kT, 12 * kT
    E_poly = np.asarray(light.planck_sample_E(
        100_000, a, b, T, bins=2000, device=True, device_method="poly"))
    E_table = np.asarray(light.planck_sample_E(
        100_000, a, b, T, bins=2000, device=True, device_method="table"))
    q = np.linspace(0.05, 0.95, 10)
    assert np.allclose(np.quantile(E_poly, q), np.quantile(E_table, q),
                       rtol=0.02)
    E_dev = np.asarray(light.PlanckSampler(a, b, T, bins=2000)
                       .sample_device(7, 100_000))
    assert np.allclose(np.quantile(E_dev, q), np.quantile(E_table, q),
                       rtol=0.02)


def test_sample_device_follows_polynomial_law():
    """``PlanckSampler.sample_device(seed, n)`` is the piecewise-poly
    inverse CDF on ``jax.random`` uniforms of ``PRNGKey(seed)``: bitwise the
    poly sampler's output, in the window, and reproducible per seed."""
    import jax

    T = 5778.0
    kT = float(light.kB.value()) * T
    a, b = 0.5 * kT, 8 * kT
    sampler = light.PlanckSampler(a, b, T, bins=500)
    E = np.asarray(sampler.sample_device(3, 4096))
    want = np.asarray(light._planck_poly(a, b, T, 500)(
        jax.random.PRNGKey(3), 4096))
    np.testing.assert_array_equal(E, want)
    assert E.shape == (4096,) and (E >= a * (1 - 1e-6)).all() \
        and (E <= b * (1 + 1e-6)).all()
    np.testing.assert_array_equal(E, np.asarray(sampler.sample_device(3, 4096)))
    assert not np.array_equal(E, np.asarray(sampler.sample_device(4, 4096)))


def test_poly_icdf_accuracy_vs_exact_inverse():
    """The warped-breakpoint, node-fitted piecewise-poly inverse CDF must
    stay within a fraction of one CDF-table bin of the exact (piecewise-
    linear) inverse on standard windows, and within 2 bins even on
    pathological near-zero-density windows (round-2 accuracy fix: uniform
    breakpoints + dense-grid fits measured ~3 bins / ~180 bins here)."""
    import jax.numpy as jnp

    kT = float(light.kB.value()) * 5778.0
    for (a_f, b_f, tol_bins) in [(0.1, 12.0, 0.1), (2.0, 10.0, 0.1),
                                 (0.01, 20.0, 2.0), (0.1, 30.0, 2.0)]:
        E_min, E_max, bins = a_f * kT, b_f * kT, 2000
        E, cdf = light.planck_cdf(E_min, E_max, 5778.0, bins)
        probs = np.concatenate([[0.0], cdf])
        dense_p = np.linspace(0.0, 1.0, 1 << 17)
        exact = np.interp(dense_p, probs, E)
        data = light._planck_poly_data(E_min, E_max, 5778.0, bins)
        approx = np.asarray(light._poly_icdf_eval(
            jnp.asarray(dense_p, jnp.float32), data))
        binw = (E_max - E_min) / bins
        max_bins = np.abs(approx - exact).max() / binw
        assert max_bins < tol_bins, (a_f, b_f, max_bins)
