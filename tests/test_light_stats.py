"""Statistical physics invariants, ported from the reference
(test/test_light.py:27-66): isotropy sign balance within 10%, and e^-1
survival at optical depth 1/(nA) within 10%."""

import pytest
import jax.numpy as jnp
import numpy as np

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def rand_ray():
    return {
        "s": np.array([0] * 3, dtype=np.double),
        "v": np.array([float(phys.light.c), 0, 0], dtype=np.double),
        "E": np.double(1),
    }


def sim(seed=0):
    s = phys.Simulation(
        bounds=np.array([1000, 1000, 1000]),
        exit=lambda cond: cond.t >= 0.100,
        seed=seed,
    )
    s.add_photons(phys.light.generate_photon_state(10000, E=1.0))
    return s


def test_scatter_spherical():
    """Spherical scattering equalizes the share of +x velocities at 50%."""
    x = sim()
    x.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    x.add_step(1, phys.newton.NewtonianKinematicsStep())
    x.add_step(2, phys.light.ScatterIsotropicStep(A=np.double(0.001),
                                                  n=np.double(0.001)))
    step = phys.light.ScatterSignMeasureStep(None, True)
    x.add_step(3, step)

    x.start()
    x.join()
    half = np.double(step.data[0][1] * 0.5)
    mean_xp = sum(y[2] for y in step.data) / len(step.data)
    error = (half - mean_xp) / half
    print("Scatter spherical test error: " + str(error))
    assert np.isclose(error, 0, 0, 0.10)


def test_scatter_delete():
    """Survival at x = 1/(nA) is proportional to e^-1."""
    x = sim()
    x.exit = lambda cond: cond.n_objects == 0
    N_i = 10000
    x.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    x.add_step(1, phys.newton.NewtonianKinematicsStep())
    n = 0.001
    A = 0.001
    x.add_step(2, phys.light.ScatterDeleteStep(np.double(n), np.double(A)))
    step = phys.light.ScatterMeasureStep(None, True,
                                         [[1 / (n * A), np.nan, np.nan]])
    x.add_step(3, step)
    x.start()
    x.join()

    N_x = sum(step.data[2])
    error = (np.e ** -1 - (N_x / N_i)) / (np.e ** -1)
    print("Scatter deletion test error: " + str(error))
    assert np.isclose(error, 0, 0, 0.10)


def test_scatter_delete_crossing_counts():
    """The plane-crossing counter itself: photons crossing x=1/(nA) sum to
    ~e^-1 of the population (uses the count channel, not the n channel)."""
    x = sim(seed=3)
    x.exit = lambda cond: cond.n_objects == 0
    N_i = 10000
    x.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    x.add_step(1, phys.newton.NewtonianKinematicsStep())
    n = 0.001
    A = 0.001
    x.add_step(2, phys.light.ScatterDeleteStep(np.double(n), np.double(A)))
    step = phys.light.ScatterMeasureStep(None, False,
                                         [[1 / (n * A), np.nan, np.nan]])
    x.add_step(3, step)
    x.start()
    x.join()

    total_crossed = sum(row[1] for row in step.data)
    # Photons move c*dt ~ 3e5 per step; all survivors cross the plane once.
    # Discrete-step survival at the crossing is (1-pcoll)^ceil(x/(c dt)),
    # pcoll = nAc dt — compare against that exact discrete expectation.
    pcoll = n * A * float(phys.light.c) * 0.001
    steps_to_plane = int(np.ceil((1 / (n * A)) / (float(phys.light.c) * 0.001)))
    expected = (1 - pcoll) ** steps_to_plane
    error = (expected - total_crossed / N_i) / expected
    print("Crossing-count error vs discrete expectation: " + str(error))
    assert np.isclose(error, 0, 0, 0.10)


def test_wavelength_dep_scattering_rate():
    """lambda^-4 weighting: photons with 2x energy scatter 16x more often
    (examples/wavelength_scattering_example.ipynb invariant). Measured as the
    single-step scatter fraction (dv != 0 after one iteration)."""
    lam_hc = float(phys.light.h) * float(phys.light.c)
    E_red = 1.0
    E_blue = 2.0
    # pcoll(E) = A*n*c*dt*(hc/E)^-4; pick A so pcoll(red)=0.02, pcoll(blue)=0.32
    base = float(phys.light.c) * 0.001 * (lam_hc / E_red) ** -4
    A = 0.02 / base

    frac = {}
    for nm, E0 in [("red", E_red), ("blue", E_blue)]:
        s = phys.Simulation(exit=lambda c_: c_.t >= 0.001, seed=11)
        s.add_photons(phys.light.generate_photon_state(20000, E=E0))
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.light.ScatterIsotropicStep(
            A=A, n=1.0, wavelength_dep_scattering=True))
        s.start()
        s.join()
        dv = np.asarray(s.sim_state.dv)
        alive = np.asarray(s.sim_state.alive)
        frac[nm] = (np.any(dv != 0, axis=0) & alive).sum() / alive.sum()
    assert np.isclose(frac["red"], 0.02, rtol=0.25)
    assert np.isclose(frac["blue"], 0.32, rtol=0.15)
    assert np.isclose(frac["blue"] / frac["red"], 16.0, rtol=0.30)


def test_variable_n_string_and_callable():
    """variable_n accepts both a C-expression string over r0/r1/r2 (reference
    surface, physicl/light.py:295-299) and a Python callable; both must agree."""
    res = {}
    for key, fn in [
        ("string", "0.001 * exp(-r0[gid] / 1000000.0)"),
        ("callable", lambda r0, r1, r2: 0.001 * jnp.exp(-r0 / 1000000.0)),
    ]:
        s = phys.Simulation(exit=lambda c_: c_.t >= 0.020, seed=5)
        s.add_photons(phys.light.generate_photon_state(2000, E=1.0))
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.light.ScatterIsotropicStep(
            A=0.001, variable_n=True, variable_n_fn=fn))
        sign = phys.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, sign)
        s.start()
        s.join()
        res[key] = np.array([row[2] for row in sign.data])
    # identical seeds + identical physics => identical trajectories
    assert np.array_equal(res["string"], res["callable"])


def test_scatter_spherical_step_alias():
    assert phys.light.ScatterSphericalStep is phys.light.ScatterIsotropicStep


def test_delete_reference_is_independent_and_cross_checks():
    """ScatterDeleteStepReference is a genuinely independent second
    implementation (the declarative-bridge rebuild, mirroring the
    reference's hand-written-vs-CLProgram pairing) — it must NOT be an
    alias, and its survival statistics must cross-check the primary
    fused/generic implementation: both follow N(k) = N0 (1-pcoll)^k with
    the same pcoll, within binomial error."""
    assert phys.light.ScatterDeleteStepReference \
        is not phys.light.ScatterDeleteStep

    n0 = 20000
    k_iters = 30
    pcoll = 0.05  # A * n * |dr| per iteration (|dr| = c * dt)
    coef = pcoll / (float(light.c) * 1e-3)

    def run(step_cls, seed):
        s = phys.Simulation(exit=lambda c: c.t >= k_iters * 1e-3 - 5e-4,
                            seed=seed)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, step_cls(np.double(1.0), np.double(coef)))
        s.add_photons(light.generate_photon_state(n0, E=1.0))
        s.start(); s.join()
        return int(np.asarray(s.sim_state.alive).sum()), s

    survivors_ref, s_ref = run(phys.light.ScatterDeleteStepReference, 3)
    survivors_pri, s_pri = run(phys.light.ScatterDeleteStep, 3)
    # the bridge rebuild is an unknown custom step to the prover
    assert not s_ref.used_fused
    expect = n0 * (1.0 - pcoll) ** k_iters
    sigma = np.sqrt(n0 * (1.0 - pcoll) ** k_iters
                    * (1.0 - (1.0 - pcoll) ** k_iters))
    assert abs(survivors_ref - expect) < 5.0 * sigma, (survivors_ref, expect)
    assert abs(survivors_pri - expect) < 5.0 * sigma, (survivors_pri, expect)
    # and against each other (independent RNG streams: ~sqrt(2) sigma)
    assert abs(survivors_ref - survivors_pri) < 7.0 * sigma


def test_scatter_constants_use_code_units():
    """Measurement n/A handed to scatter steps must be converted to CODE
    units (the state's units), not SI: under set_code_scale('m', 0.001) the
    e^-1-survival acceptance scenario must still hold (regression for the
    _as_code fix; the SI-unscaled conversion made absorption ~vanish)."""
    phys.set_code_scale("m", 0.001)
    light.refresh_constants()
    try:
        n_m = phys.Measurement(2e25, "m**-3")
        A_m = phys.Measurement(5.1e-31, "m**2")
        n_c = float(n_m.view(np.ndarray))
        A_c = float(A_m.view(np.ndarray))
        mfp = 1 / (n_c * A_c)
        c_code = float(light.c)
        N = 100_000
        dt = mfp / c_code / 50.5
        s = phys.Simulation(seed=0, exit=lambda v: v.t >= dt * 220)
        s.add_step(0, phys.UpdateTimeStep(lambda v: np.double(dt)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(n_m, A_m))
        meas = light.ScatterMeasureStep(None, True, [[mfp, np.nan, np.nan]])
        s.add_step(3, meas)
        s.add_photons(light.generate_photon_state(N, E=1.0))
        s.start(); s.join()
        survived = sum(int(r[2]) for r in meas.data) / N
        err = abs(np.e ** -1 - survived) / np.e ** -1
        assert err < 0.10, (survived, np.e ** -1)
    finally:
        phys.reset_code_scale("m")
        light.refresh_constants()


# ---------------------------------------------------------------------------
# Henyey-Greenstein anisotropic scattering (extension: the reference has
# only isotropic scattering; HG is the standard single-parameter anisotropic
# phase function and <cos theta> == g is its defining property).
# ---------------------------------------------------------------------------


def _hg_one_scatter(g, fuse, n=20000, seed=3):
    """One guaranteed scatter (pcoll >> 1) from a +x beam; returns the
    final (v, dv) arrays and the sim."""
    s = phys.Simulation(until_t=0.001, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterHenyeyGreensteinStep(A=1.0, n=1.0, g=g))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    v = np.asarray(s.sim_state.v)[:, :n]
    dv = np.asarray(s.sim_state.dv)[:, :n]
    return v, dv, s


@pytest.mark.slow
def test_hg_mean_cosine_equals_g_both_paths():
    c_val = float(light.c)
    for g in (0.0, 0.5, 0.9, -0.4):
        for fuse in ("auto", "off"):
            v, dv, s = _hg_one_scatter(g, fuse)
            scattered = np.any(dv != 0, axis=0)
            assert scattered.mean() > 0.999  # pcoll = c*dt >> 1
            # incoming beam was +x: cos(theta) = vx_new / |v|
            cos_t = v[0, scattered] / c_val
            # sampling noise ~ sqrt((1-g^2)/N); allow 5 sigma + fast-trig bias
            tol = 5 * np.sqrt(max(1 - g * g, 0.05) / scattered.sum()) + 0.01
            assert abs(cos_t.mean() - g) < tol, (g, fuse, cos_t.mean())
            # speed preserved through the frame rotation
            speed = np.sqrt((v[:, scattered] ** 2).sum(axis=0))
            np.testing.assert_allclose(speed, c_val, rtol=2e-5)


def test_hg_azimuthal_symmetry():
    """Azimuth around the incoming +x beam is uniform: mean vy and vz of
    scattered photons vanish, for strong forward peaking too."""
    for fuse in ("auto", "off"):
        v, dv, _ = _hg_one_scatter(0.8, fuse, n=40000)
        scattered = np.any(dv != 0, axis=0)
        c_val = float(light.c)
        for comp in (1, 2):
            m = (v[comp, scattered] / c_val).mean()
            assert abs(m) < 0.01, (fuse, comp, m)


def test_hg_g_zero_matches_area_uniform_isotropic():
    """g=0 is TRUE isotropic (area-uniform cos): mean cos == 0 and the
    cos histogram is flat — distinguishable from the reference's
    angle-uniform ScatterIsotropicStep distribution."""
    v, dv, _ = _hg_one_scatter(0.0, "auto", n=50000)
    scattered = np.any(dv != 0, axis=0)
    cos_t = v[0, scattered] / float(light.c)
    hist, _ = np.histogram(cos_t, bins=10, range=(-1, 1), density=True)
    np.testing.assert_allclose(hist, 0.5, atol=0.03)


def test_hg_options_variable_n_and_wavelength():
    """The shared collision-model options stay available and fused."""
    s = phys.Simulation(until_t=0.003, seed=1)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterHenyeyGreensteinStep(
        A=1e-3, n=1.0, g=0.6, variable_n=True,
        variable_n_fn="exp(-r0[gid] / 1e9)"))
    s.add_photons(light.generate_photon_state(4096, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.ts) == 3


def test_hg_g_validation():
    import pytest as _pytest
    with _pytest.raises(ValueError, match="-1"):
        light.ScatterHenyeyGreensteinStep(g=1.0)


# ---------------------------------------------------------------------------
# Rayleigh dipole phase function (extension): the reference applies the
# lambda^-4 cross-section but redirects isotropically; ScatterRayleighStep
# samples the TRUE (3/8)(1+cos^2) phase via the closed-form Cardano inverse
# CDF. Defining property: <cos^2 theta> = 2/5 (isotropic gives 1/3).
# ---------------------------------------------------------------------------


def _rayleigh_one_scatter(fuse, n=40000, seed=3):
    s = phys.Simulation(until_t=0.001, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterRayleighStep(A=1.0, n=1.0))
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    v = np.asarray(s.sim_state.v)[:, :n]
    dv = np.asarray(s.sim_state.dv)[:, :n]
    return v, dv


def test_rayleigh_phase_moments_both_paths():
    c_val = float(light.c)
    for fuse in ("auto", "off"):
        v, dv = _rayleigh_one_scatter(fuse)
        sc = np.any(dv != 0, axis=0)
        assert sc.mean() > 0.999  # pcoll = c*dt >> 1
        cos_t = v[0, sc] / c_val
        n = sc.sum()
        # symmetric phase: <cos> = 0 (var = 2/5); <cos^2> = 2/5 exactly
        assert abs(cos_t.mean()) < 5 * np.sqrt(0.4 / n) + 0.005, fuse
        m2 = (cos_t ** 2).mean()
        # var(cos^2) = E[c^4] - (2/5)^2 = 11/35... ~ 0.155; 5 sigma
        assert abs(m2 - 0.4) < 5 * np.sqrt(0.155 / n) + 0.005, (fuse, m2)
        speed = np.sqrt((v[:, sc] ** 2).sum(axis=0))
        np.testing.assert_allclose(speed, c_val, rtol=2e-5)


def test_rayleigh_cos_histogram_matches_phase_function():
    """Sampled cos-theta density matches (3/8)(1 + cos^2) per bin."""
    v, dv = _rayleigh_one_scatter("auto", n=100_000)
    sc = np.any(dv != 0, axis=0)
    cos_t = v[0, sc] / float(light.c)
    hist, edges = np.histogram(cos_t, bins=16, range=(-1, 1), density=True)
    mid = 0.5 * (edges[:-1] + edges[1:])
    expect = (3.0 / 8.0) * (1.0 + mid ** 2)
    np.testing.assert_allclose(hist, expect, atol=0.02)


def test_rayleigh_inverse_cdf_exact():
    """The Cardano closed form inverts the phase-function CDF to f32
    precision: CDF(icdf(u)) == u."""
    import jax.numpy as jnp
    from physicl_tpu.light import _rayleigh_cos_theta

    u = np.linspace(0.0, 1.0, 4001)
    c = np.asarray(_rayleigh_cos_theta(jnp.asarray(u, jnp.float32),
                                       jnp.float32), np.float64)
    assert c[0] == -1.0 and c[-1] == 1.0
    cdf = (c ** 3 + 3 * c + 4.0) / 8.0
    np.testing.assert_allclose(cdf, u, atol=2e-6)


def test_rayleigh_options_and_azimuth():
    """Shared collision options stay fused; azimuth around the beam is
    uniform (mean vy, vz vanish)."""
    s = phys.Simulation(until_t=0.003, seed=1)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterRayleighStep(
        A=1e-3, n=1.0, variable_n=True,
        variable_n_fn="exp(-r0[gid] / 1e9)"))
    s.add_photons(light.generate_photon_state(4096, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.ts) == 3

    v, dv = _rayleigh_one_scatter("auto")
    sc = np.any(dv != 0, axis=0)
    for comp in (1, 2):
        m = (v[comp, sc] / float(light.c)).mean()
        assert abs(m) < 0.01, (comp, m)


def test_non_scalar_step_constant_fails_at_constructor():
    """A concrete non-scalar A/n raises at construction, not as a cryptic
    broadcast error inside a later trace (review finding: the tracer
    pass-through in _as_code must not swallow TypeError)."""
    import pytest
    with pytest.raises(TypeError):
        light.ScatterDeleteStep(n=np.double(1.0), A=np.array([1e-3, 2e-3]))
    with pytest.raises(TypeError):
        light.ScatterIsotropicStep(n=[1.0, 2.0], A=1e-3)
