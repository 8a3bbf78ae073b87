"""LorentzForceStep (Boris pusher) — charged-particle dynamics in E/B
fields (extension; the reference stores ``a`` but integrates no forces).
Validates the three defining Boris properties: exact speed conservation on
gyro-orbits, the discrete gyro-phase 2*atan(h|B|) per step, exact
constant-E acceleration; plus the ExB drift, per-particle q/m, spatially
varying fields, and photon immunity."""

import jax
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton as newton


DT = 1e-3


def _sim(steps, objs, n_steps, seed=0):
    s = phys.Simulation(until_t=DT * n_steps * 0.9999, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    for i, st in enumerate(steps):
        s.add_step(1 + i, st)
    for o in objs:
        s.add_obj(o)
    s.start(); s.join()
    st = s.sim_state
    n = len(objs)
    return (s, np.asarray(jax.device_get(st.r))[:, :n],
            np.asarray(jax.device_get(st.v))[:, :n])


def test_pure_E_accelerates_exactly():
    """B=0 Boris is exact: v_x = (q/m) E0 t after every step."""
    k = 50
    s, r, v = _sim(
        [newton.LorentzForceStep(E_field=(3.0, 0.0, 0.0), q_over_m=2.0),
         newton.NewtonianKinematicsStep()],
        [phys.Object()], k)
    np.testing.assert_allclose(v[0, 0], 2.0 * 3.0 * DT * k, rtol=1e-5)
    assert v[1, 0] == 0.0 and v[2, 0] == 0.0
    # position: r = sum_{i=1..k} v_i dt = a dt^2 k(k+1)/2
    np.testing.assert_allclose(r[0, 0], 6.0 * DT * DT * k * (k + 1) / 2,
                               rtol=1e-5)


def test_gyro_orbit_speed_exact_and_phase():
    """Pure B: |v| conserved to f32 roundoff over 500 steps (the Boris
    rotation is exact); phase advance per step is 2*atan(h|B|), clockwise
    for q>0, B=+z."""
    B0, qm, v0 = 200.0, 1.0, 7.0
    k = 500
    s, r, v = _sim(
        [newton.LorentzForceStep(B_field=(0.0, 0.0, B0), q_over_m=qm),
         newton.NewtonianKinematicsStep()],
        [phys.Object(v=phys.Measurement([v0, 0, 0], "m**1 s**-1"))], k)
    speed = np.linalg.norm(v[:, 0])
    np.testing.assert_allclose(speed, v0, rtol=2e-5)
    theta = 2.0 * np.arctan(0.5 * qm * B0 * DT)
    expect = -k * theta  # q>0, B=+z gyrates clockwise in xy
    got = np.arctan2(v[1, 0], v[0, 0])
    # compare as complex phases (mod 2pi)
    np.testing.assert_allclose(np.exp(1j * got), np.exp(1j * expect),
                               atol=2e-4)
    assert v[2, 0] == 0.0


def test_exb_drift():
    """Crossed fields: guiding center drifts at E x B / B^2, independent of
    q/m. Start at rest; average velocity over many gyro-periods converges
    to the drift (gyration is bounded)."""
    E0, B0 = 4.0, 200.0
    k = 4000
    s, r, v = _sim(
        [newton.LorentzForceStep(E_field=(E0, 0.0, 0.0),
                                 B_field=(0.0, 0.0, B0), q_over_m=1.0),
         newton.NewtonianKinematicsStep()],
        [phys.Object()], k)
    drift = np.array([0.0, -E0 / B0, 0.0])
    v_avg = r[:, 0] / (k * DT)
    np.testing.assert_allclose(v_avg, drift, atol=0.02 * E0 / B0)


def test_per_particle_charge_sign():
    """ChargedObject(q=, m=): opposite charges gyrate in opposite senses;
    an uncharged Object (q=m=0 extras) is not pushed."""
    B0, v0 = 200.0, 5.0
    vv = phys.Measurement([v0, 0, 0], "m**1 s**-1")
    s, r, v = _sim(
        [newton.LorentzForceStep(B_field=(0.0, 0.0, B0)),
         newton.NewtonianKinematicsStep()],
        [newton.ChargedObject(q=1.0, m=1.0, v=vv),
         newton.ChargedObject(q=-1.0, m=1.0, v=vv),
         phys.Object(v=vv)],
        100)
    # equal and opposite vy; the neutral particle keeps +x exactly
    assert v[1, 0] < -0.1 * v0 and v[1, 1] > 0.1 * v0
    np.testing.assert_allclose(v[1, 0], -v[1, 1], rtol=1e-5)
    np.testing.assert_allclose(v[:, 2], [v0, 0.0, 0.0], rtol=1e-6)
    # both charged speeds conserved
    np.testing.assert_allclose(np.linalg.norm(v[:, :2], axis=0), v0,
                               rtol=2e-5)


def test_photons_never_pushed():
    """Photons coexisting with charged particles are immune to the fields
    (massless; the step is charge dynamics only)."""
    c = float(light.c)
    s = phys.Simulation(until_t=0.005, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(E_field=(1e6, 0, 0),
                                          B_field=(0, 0, 1e3),
                                          q_over_m=1.0))
    s.add_step(2, newton.NewtonianKinematicsStep())
    s.add_obj(light.PhotonObject(
        E=np.double(1.0), v=np.array([c, 0, 0], dtype=np.double)))
    s.add_obj(phys.Object())
    s.start(); s.join()
    v = np.asarray(jax.device_get(s.sim_state.v))[:, :2]
    np.testing.assert_allclose(v[:, 0], [c, 0.0, 0.0], rtol=1e-6)
    assert abs(v[0, 1]) > 0  # the massive particle DID accelerate


def test_spatially_varying_field():
    """Callable B(r): a field reversing sign across x=0 bends two particles
    started on either side in opposite directions."""
    def B(rx, ry, rz):
        return (0.0 * rx, 0.0 * rx, 100.0 * np.sign(1.0) * jax.numpy.sign(rx))

    vv = phys.Measurement([0, 3.0, 0], "m**1 s**-1")
    s, r, v = _sim(
        [newton.LorentzForceStep(B_field=B, q_over_m=1.0),
         newton.NewtonianKinematicsStep()],
        [phys.Object(r=phys.Measurement([1.0, 0, 0], "m**1"), v=vv),
         phys.Object(r=phys.Measurement([-1.0, 0, 0], "m**1"), v=vv)],
        10)  # ~1 rad of gyration: sign of vx is unambiguous
    # v x B with B = +z at x>0: vy>0 -> Fx = q vy Bz > 0; mirrored at x<0
    assert v[0, 0] > 0.5 and v[0, 1] < -0.5
    np.testing.assert_allclose(v[0, 0], -v[0, 1], rtol=1e-5)


def test_missing_charge_errors():
    s = phys.Simulation(until_t=0.001, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, 1.0)))
    s.add_obj(phys.Object())
    s.start()
    with pytest.raises(ValueError, match="q_over_m"):
        s.join()


def test_charged_object_validation():
    with pytest.raises(ValueError):
        newton.ChargedObject(q=1.0)
    with pytest.raises(ValueError):
        newton.ChargedObject(q=1.0, m=0.0)


def test_species_wide_lorentz_fuses():
    """An all-generic population with a species-wide q_over_m runs INSIDE
    the fused Pallas kernel (charged-particle fused path)."""
    s = phys.Simulation(until_t=0.002, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, 1.0), q_over_m=1.0))
    s.add_step(2, newton.NewtonianKinematicsStep())
    s.add_obj(newton.ChargedObject(q=1.0, m=1.0))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()


def test_per_particle_qm_fuses_via_extras_plane():
    """q_over_m=None with ChargedObject(q=, m=) packs a derived q/m extras
    plane: the pipeline fuses, opposite charges gyrate in opposite senses,
    and an uncharged Object (qm plane 0) is never pushed — exactly the
    generic-path semantics."""
    B0, v0, k = 200.0, 5.0, 100
    vv = phys.Measurement([v0, 0, 0], "m**1 s**-1")
    s = phys.Simulation(until_t=DT * k * 0.9999, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, B0)))
    s.add_step(2, newton.NewtonianKinematicsStep())
    for o in (newton.ChargedObject(q=1.0, m=1.0, v=vv),
              newton.ChargedObject(q=-1.0, m=1.0, v=vv),
              phys.Object(v=vv)):
        s.add_obj(o)
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    v = np.asarray(jax.device_get(s.sim_state.v))[:, :3]
    assert v[1, 0] < -0.1 * v0 and v[1, 1] > 0.1 * v0
    np.testing.assert_allclose(v[1, 0], -v[1, 1], rtol=1e-5)
    np.testing.assert_allclose(v[:, 2], [v0, 0.0, 0.0], rtol=1e-6)


def test_per_particle_qm_without_extras_reports_generic_fallback():
    """q_over_m=None over a population that never declares q/m extras must
    NOT fuse: the generic path raises the instructive error."""
    s = phys.Simulation(until_t=0.002, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, 1.0)))
    s.add_step(2, newton.NewtonianKinematicsStep())
    s.add_obj(phys.Object())
    s.start()
    with pytest.raises(ValueError, match="q_over_m"):
        s.join()


def test_fused_vs_generic_parity_exact_observables():
    """Boris dynamics has no RNG: the fused Pallas kernel and the generic
    scan must agree on every particle's r and v to f32 roundoff, including
    spatially varying B, constant E, and a reflecting box."""
    rng = np.random.default_rng(7)
    n, k = 96, 120
    v0 = rng.normal(size=(3, n))
    r0 = rng.normal(size=(3, n)) * 0.01

    def b_fn(rx, ry, rz):
        return (0.3 * ry, 0.0 * rx, 40.0 + 5.0 * rx)

    outs = []
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=DT * k * 0.9999, seed=3, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, newton.LorentzForceStep(
            E_field=(0.5, -0.2, 0.1), B_field=b_fn, q_over_m=-1.5))
        s.add_step(2, newton.NewtonianKinematicsStep())
        s.add_step(3, newton.ReflectingBoundaryStep(
            bounds=((-0.5, 0.5), (-0.5, 0.5), (-0.5, 0.5))))
        for i in range(n):
            s.add_obj(phys.Object(
                r=phys.Measurement(r0[:, i], "m**1"),
                v=phys.Measurement(v0[:, i], "m**1 s**-1")))
        s.start(); s.join()
        st = s.sim_state
        outs.append((s.used_fused,
                     np.asarray(jax.device_get(st.r))[:, :n],
                     np.asarray(jax.device_get(st.v))[:, :n]))
    assert outs[0][0] and not outs[1][0]
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=3e-5, atol=3e-6)


def test_photon_population_lorentz_noop_still_fuses():
    """A Lorentz step in an all-photon population fuses as the generic
    path's exact no-op (photons immune; dv zeroed)."""
    c = float(light.c)
    s = phys.Simulation(until_t=0.003, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(E_field=(1e6, 0, 0),
                                          B_field=(0, 0, 1e4),
                                          q_over_m=1e8))
    s.add_step(2, newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(64, E=1.0))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    st = s.sim_state
    v = np.asarray(jax.device_get(st.v))[:, :64]
    np.testing.assert_allclose(v[0], c, rtol=1e-6)
    assert np.all(v[1] == 0.0) and np.all(v[2] == 0.0)
    dv = np.asarray(jax.device_get(st.dv))[:, :64]
    assert np.all(dv == 0.0)


def test_mixed_species_fused_transport():
    """Photons + charged particles in ONE fused pipeline: the otype plane
    routes isotropic scattering + absorption to the photon subset and the
    Boris push to the charged subset. Checks generic-path parity on the
    deterministic observables and physics on each species."""
    c = float(light.c)
    n_ph, n_ch, k = 4000, 64, 30
    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=DT * k * 0.9999, seed=5, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, 200.0),
                                              q_over_m=1.0))
        s.add_step(2, newton.NewtonianKinematicsStep())
        s.add_step(3, light.ScatterIsotropicStep(A=0.02 / (c * DT), n=1.0))
        s.add_step(4, light.ScatterDeleteStep(
            np.double(0.01 / (c * DT)), np.double(1.0)))
        meas = light.ScatterSignMeasureStep(None, True)
        s.add_step(5, meas)
        s.add_photons(light.generate_photon_state(n_ph, E=1.0))
        for i in range(n_ch):
            s.add_obj(newton.ChargedObject(
                q=1.0, m=1.0,
                v=phys.Measurement([3.0, 0, 0], "m**1 s**-1")))
        s.start(); s.join()
        st = s.sim_state
        v = np.asarray(jax.device_get(st.v))
        alive = np.asarray(jax.device_get(st.alive))
        otype = np.asarray(jax.device_get(st.otype))
        out[fuse] = (s.used_fused, len(s.ts),
                     np.array([r[1] for r in meas.data], float), v, alive,
                     otype)
    a, b = out["auto"], out["off"]
    assert a[0] and not b[0]
    assert a[1] == b[1]
    # photons die at the same expected rate on both paths (absorption is
    # stochastic: sqrt-bound), charged particles NEVER die
    for fused_run in (a, b):
        n_t, v, alive, otype = (fused_run[2], fused_run[3], fused_run[4],
                                fused_run[5])
        charged = otype != 1
        assert alive[charged].sum() == n_ch
        # every charged particle still gyrates at speed 3 exactly
        sp = np.linalg.norm(v[:, charged & alive], axis=0)
        np.testing.assert_allclose(sp, 3.0, rtol=3e-5)
        # photons that survived still move at c
        ph_alive = (otype == 1) & alive
        if ph_alive.any():
            np.testing.assert_allclose(
                np.linalg.norm(v[:, ph_alive], axis=0), c, rtol=3e-5)
        # absorption: expected survivors n_ph * (1 - 0.01)^k + charged
        expect = n_ph * (1.0 - 0.01) ** k + n_ch
        assert abs(n_t[-1] - expect) < 6 * np.sqrt(n_ph * 0.26) + 40
    # cross-path population trajectories agree within binomial noise
    hi = np.maximum(np.maximum(a[2], b[2]), 1)
    assert np.all(np.abs(a[2] - b[2]) <= 6 * np.sqrt(hi) + 0.02 * hi)


def test_varying_dt_lorentz_before_update_parity():
    """With a time-varying dt and the order [Lorentz, UpdateTime, Kin], the
    Lorentz kick must use the PRE-update dt (what the generic step sees at
    its position) — regression for the fused schedule handing it the
    kinematics-position dt."""
    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.02, seed=0, fuse=fuse)
        s.add_step(0, newton.LorentzForceStep(E_field=(2.0, 0, 0),
                                              q_over_m=1.0))
        s.add_step(1, phys.UpdateTimeStep(
            lambda x: 1e-3 * (1.0 + 200.0 * x.t)))
        s.add_step(2, newton.NewtonianKinematicsStep())
        s.add_obj(phys.Object())
        s.start(); s.join()
        out[fuse] = (s.used_fused, len(s.ts),
                     np.asarray(jax.device_get(s.sim_state.v))[:, 0],
                     np.asarray(jax.device_get(s.sim_state.r))[:, 0])
    a, b = out["auto"], out["off"]
    assert a[0] and not b[0]
    assert a[1] == b[1]
    np.testing.assert_allclose(a[2], b[2], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a[3], b[3], rtol=1e-6, atol=1e-7)


def test_mixed_population_per_particle_qm():
    """Photons + per-particle-q/m charges: BOTH extras planes (otype + qm)
    pack together; photons immune, opposite charges mirror, fused."""
    B0, v0, k = 200.0, 5.0, 100
    vv = phys.Measurement([v0, 0, 0], "m**1 s**-1")
    s = phys.Simulation(until_t=DT * k * 0.9999, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, newton.LorentzForceStep(B_field=(0, 0, B0)))
    s.add_step(2, newton.NewtonianKinematicsStep())
    s.add_obj(newton.ChargedObject(q=1.0, m=1.0, v=vv))
    s.add_obj(newton.ChargedObject(q=-1.0, m=1.0, v=vv))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    assert "otype" in s.explain_plan() and "qm" in s.explain_plan()
    v = np.asarray(jax.device_get(s.sim_state.v))
    np.testing.assert_allclose(v[1, 0], -v[1, 1], rtol=1e-5)
    assert abs(v[1, 0]) > 0.1 * v0
    # photons (slots 2..66) untouched at +x c
    c = float(light.c)
    np.testing.assert_allclose(v[0, 2:66], c, rtol=1e-6)
    assert np.all(v[1, 2:66] == 0.0)


def test_bad_field_vector_names_the_field():
    with pytest.raises(ValueError, match="B_field"):
        newton.LorentzForceStep(B_field=(1.0, 2.0), q_over_m=1.0)
    with pytest.raises(ValueError, match="E_field"):
        newton.LorentzForceStep(E_field="up", q_over_m=1.0)
