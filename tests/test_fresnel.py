"""RefractiveInterfaceStep: Fresnel reflection / Snell refraction at plane
interfaces (extension — the reference has no geometry beyond an infinite
homogeneous medium). Validates exact single-photon kinematics, Snell's law
per transmitted photon, Fresnel reflectance statistics, total internal
reflection (deterministic), match_speed=True c/n speeds, and a two-interface
slab against the incoherent multiple-reflection sum T = (1-R)/(1+R)."""

import jax
import numpy as np

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton as newton


C = float(light.c)
DT = 1e-3


def _run(step_or_steps, v_dir, n, fuse, r0=(0.0, 0.0, -1e5), seed=0,
         n_steps=1):
    """One (or more) fixed-dt iterations of kin + interface step(s)."""
    s = phys.Simulation(until_t=DT * n_steps * 0.9999, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.NewtonianKinematicsStep())
    steps = (step_or_steps if isinstance(step_or_steps, (list, tuple))
             else [step_or_steps])
    for i, st in enumerate(steps):
        s.add_step(2 + i, st)
    d = np.asarray(v_dir, np.float64)
    d = d / np.linalg.norm(d)
    s.add_photons(light.generate_photon_state(
        n, E=1.0, v=d * C, r=np.asarray(r0, np.float64)))
    s.start(); s.join()
    st = s.sim_state
    v = np.asarray(jax.device_get(st.v))[:, :n]
    r = np.asarray(jax.device_get(st.r))[:, :n]
    return s, r, v


def test_snell_angle_exact_per_photon():
    """45-degree incidence, n=1 -> 1.5: every transmitted photon satisfies
    sin_t = sin_i / 1.5 exactly (f32), azimuth and |v| preserved; every
    reflected photon mirrors vz. Both execution paths."""
    for fuse in ("auto", "off"):
        step = light.RefractiveInterfaceStep(0.0, 1.0, 1.5)
        s, r, v = _run(step, (1.0, 0.0, 1.0), 4096, fuse)
        assert s.used_fused == (fuse == "auto")
        speed = np.linalg.norm(v, axis=0)
        np.testing.assert_allclose(speed, C, rtol=1e-5)
        up = v[2] > 0
        sin_i = np.sqrt(0.5)
        # transmitted: Snell bend, azimuth (x of the tangential plane) kept
        sin_t = v[0, up] / speed[up]
        np.testing.assert_allclose(sin_t, sin_i / 1.5, rtol=1e-5)
        assert np.all(np.abs(v[1, up]) < 1e-3 * C)
        assert np.all(r[2, up] > 0)
        # reflected: exact specular mirror
        dn = ~up
        np.testing.assert_allclose(v[0, dn] / speed[dn], sin_i, rtol=1e-5)
        np.testing.assert_allclose(v[2, dn] / speed[dn], -sin_i, rtol=1e-5)
        assert np.all(r[2, dn] < 0)
        # Fresnel R(45 deg, 1->1.5) ~ 0.0497: both outcomes well populated
        frac = dn.mean()
        assert 0.02 < frac < 0.09, frac


def test_normal_incidence_reflectance_statistics():
    """R(0 deg) = ((n1-n2)/(n1+n2))^2 = 0.04 for glass; binomial check at
    2e5 photons (sigma ~ 4.4e-4) on both paths."""
    for fuse, seed in (("auto", 1), ("off", 2)):
        step = light.RefractiveInterfaceStep(0.0, 1.0, 1.5)
        s, r, v = _run(step, (0.0, 0.0, 1.0), 200_000, fuse, seed=seed)
        frac = (v[2] < 0).mean()
        assert abs(frac - 0.04) < 0.0035, (fuse, frac)


def test_total_internal_reflection_deterministic():
    """From the dense side (n=1.5) at 60 deg > critical 41.8 deg: every
    photon reflects — exact, no randomness survives."""
    d = (np.sin(np.pi / 3), 0.0, np.cos(np.pi / 3))
    for fuse in ("auto", "off"):
        step = light.RefractiveInterfaceStep(0.0, 1.5, 1.0)
        s, r, v = _run(step, d, 2048, fuse)
        assert np.all(v[2] < 0)
        assert np.all(r[2] < 0)
        np.testing.assert_allclose(np.linalg.norm(v, axis=0), C, rtol=1e-5)


def test_single_photon_kink_on_interface():
    """TIR path is deterministic: the photon must travel to the segment/plane
    intersection, then retrace the remainder mirrored — matches the hand
    computation exactly (f32)."""
    theta = np.pi / 3
    d = np.array([np.sin(theta), 0.0, np.cos(theta)])
    z0 = -1e5
    seg = C * DT
    s_frac = -z0 / (d[2] * seg)          # fraction of the step to the plane
    p = np.array([0.0, 0.0, z0]) + s_frac * d * seg
    d_ref = d * np.array([1.0, 1.0, -1.0])
    expect = p + (1.0 - s_frac) * seg * d_ref
    for fuse in ("auto", "off"):
        step = light.RefractiveInterfaceStep(0.0, 1.5, 1.0)
        s, r, v = _run(step, d, 1, fuse, r0=(0.0, 0.0, z0))
        np.testing.assert_allclose(r[:, 0], expect, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(v[:, 0], d_ref * C, rtol=1e-5)


def test_match_speed_sets_c_over_n():
    """match_speed=True: transmitted photons leave at c/n2, reflected at
    c/n1; default keeps |v| untouched."""
    for fuse in ("auto", "off"):
        step = light.RefractiveInterfaceStep(0.0, 1.0, 1.5, match_speed=True)
        s, r, v = _run(step, (0.0, 0.0, 1.0), 65536, fuse, seed=7)
        speed = np.linalg.norm(v, axis=0)
        up = v[2] > 0
        np.testing.assert_allclose(speed[up], C / 1.5, rtol=1e-5)
        np.testing.assert_allclose(speed[~up], C, rtol=1e-5)
        # transmitted photons are in the slow medium: remaining step length
        # shrank by the speed ratio, but all crossed the plane
        assert np.all(r[2, up] > 0) and np.all(r[2, ~up] < 0)


def test_slab_transmission_matches_multiple_reflection_sum():
    """Normal-incidence slab (two interfaces): total transmission is the
    incoherent Airy sum T = (1-R)^2 * sum R^(2k) = (1-R)/(1+R) = 0.9231
    for R = 0.04 — photons bounce between BOTH interfaces until they leave,
    so this validates multi-interface composition, not just one event."""
    # slab thicker than one step length: a photon can never cross both
    # faces inside a single iteration (the step interacts each photon at
    # most once per iteration per interface)
    L = 1.5 * C * DT
    n_ph = 100_000
    expect = (1 - 0.04) / (1 + 0.04)
    for fuse, seed in (("auto", 11), ("off", 12)):
        steps = [light.RefractiveInterfaceStep(0.0, 1.0, 1.5),
                 light.RefractiveInterfaceStep(L, 1.5, 1.0)]
        s, r, v = _run(steps, (0.0, 0.0, 1.0), n_ph, fuse,
                       r0=(0.0, 0.0, -0.5 * C * DT), n_steps=40)
        assert s.used_fused == (fuse == "auto")
        # after 40 steps the in-slab population is ~R^k ~ 0: everyone
        # has exited; transmitted = above the slab going up
        trans = ((r[2] > L) & (v[2] > 0)).mean()
        refl = ((r[2] < 0) & (v[2] < 0)).mean()
        assert abs(trans - expect) < 0.004, (fuse, trans)
        assert abs(refl - (1 - expect)) < 0.004, (fuse, refl)


def test_fused_matches_generic_reflectance():
    """Same-shape statistics between the Pallas plan and the generic scan
    (different RNG streams; binomial-level agreement)."""
    out = {}
    for fuse in ("auto", "off"):
        step = light.RefractiveInterfaceStep(0.0, 1.0, 2.0)
        s, r, v = _run(step, (1.0, 0.0, 2.0), 50_000, fuse, seed=3)
        out[fuse] = (v[2] < 0).mean()
    assert abs(out["auto"] - out["off"]) < 0.006, out


def test_energy_plane_untouched():
    step = light.RefractiveInterfaceStep(0.0, 1.0, 1.5)
    s, r, v = _run(step, (0.0, 0.0, 1.0), 1024, "auto", seed=4)
    E = np.asarray(jax.device_get(s.sim_state.E))[:1024]
    np.testing.assert_allclose(E, 1.0, rtol=1e-6)


def test_validation_errors():
    import pytest

    with pytest.raises(ValueError):
        light.RefractiveInterfaceStep(0.0, -1.0, 1.5)
    with pytest.raises(ValueError):
        light.RefractiveInterfaceStep(0.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        light.RefractiveInterfaceStep(0.0, 1.0, 1.5, axis=3)
