"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light
from physicl_tpu.parallel import make_mesh, shard_state, PHOTON_AXIS
from physicl_tpu.state import SimState


def _n_dev():
    return len(jax.devices())


pytestmark = pytest.mark.usefixtures("eight_devices")


def test_virtual_devices_present():
    assert _n_dev() >= 8


def test_shard_state_layout():
    mesh = make_mesh()
    state = SimState.from_population(
        [], [light.generate_photon_state(100000, E=1.0)],
        capacity=8 * 16384)
    st = shard_state(state, mesh)
    # particle axis sharded 8 ways; scalars replicated
    assert st.r.sharding.spec == (None, PHOTON_AXIS)
    assert st.E.sharding.spec == (PHOTON_AXIS,)
    assert st.t.sharding.spec == ()


def _run(mesh, fuse, seed=0, n=20000, delete=False):
    s = phys.Simulation(exit=lambda c: c.t >= 0.020, seed=seed, fuse=fuse,
                        mesh=mesh)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    if delete:
        s.exit = lambda x: len(x.objects) == 0
        s.add_step(2, light.ScatterDeleteStep(np.double(0.001),
                                              np.double(0.001)))
        meas = light.ScatterMeasureStep(None, True, [[1e6, np.nan, np.nan]])
    else:
        s.add_step(2, light.ScatterIsotropicStep(A=0.001, n=0.001))
        meas = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, meas)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    return s, meas


def test_sharded_generic_matches_unsharded():
    mesh = make_mesh()
    res = {}
    for key, m in [("mesh", mesh), ("single", None)]:
        s, meas = _run(m, fuse="off", seed=4)
        res[key] = np.array([row[2] / row[1] for row in meas.data])
    # same physics, different RNG partitioning: statistical agreement
    assert len(res["mesh"]) == len(res["single"])
    assert np.abs(res["mesh"] - res["single"]).max() < 0.03


def test_sharded_fused_runs_and_matches():
    mesh = make_mesh()
    s, meas = _run(mesh, fuse="auto", seed=4)
    assert s.used_fused
    shares = np.array([row[2] / row[1] for row in meas.data])
    # analytic relaxation: scattering erases the +x bias completely, so
    # share_k = 0.5 + 0.5*(1 - pcoll)^k with pcoll = A*n*c*dt = 0.2998
    pcoll = 0.001 * 0.001 * float(light.c) * 0.001
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, len(shares) + 1)
    assert np.abs(shares - expect).max() < 0.02


def test_sharded_fused_delete_extinction():
    mesh = make_mesh()
    s, meas = _run(mesh, fuse="auto", seed=9, delete=True)
    assert s.used_fused
    assert len(s.objects) == 0
    decay = meas.data[1][1] / meas.data[0][1]
    assert np.isclose(decay, 0.7002, atol=0.02)


def test_sharded_measurement_reductions_are_global():
    """Counts must cover ALL shards, not one (psum over ICI)."""
    mesh = make_mesh()
    s, meas = _run(mesh, fuse="auto", seed=4, n=16384 * 8)
    assert int(meas.data[0][1]) == 16384 * 8


def test_sharded_fused_emitter_windows_cross_shards():
    """Emission windows are written piecewise when they straddle a shard
    boundary; counts must be exact across the whole mesh."""
    mesh = make_mesh()
    # capacity 8 shards x 16384; emission of 3000/step starts at hwm=10000
    # and repeatedly crosses the 16384-multiple shard boundaries
    s = phys.Simulation(exit=lambda c: c.t >= 0.020, seed=0, mesh=mesh,
                        capacity=16384 * 8)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, light.PhotonEmitterStep(3000, E=2.0))
    s.add_step(2, phys.newton.NewtonianKinematicsStep())
    sign = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(light.generate_photon_state(10000, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    ns = [int(r[1]) for r in sign.data]
    assert ns == [10000 + 3000 * (i + 1) for i in range(20)]
    E = np.asarray(jax.device_get(s.sim_state.E))
    alive = np.asarray(jax.device_get(s.sim_state.alive))
    assert (E[alive] == 2.0).sum() == 60000
    assert (E[alive] == 1.0).sum() == 10000


def test_sharded_emitter_full_arena_stops_cleanly():
    """With nothing dying, recycle compaction has nothing to reclaim: a
    source on a full arena stops emitting — identical counts fused vs
    generic. (Sustained sources with absorption DO recycle on a mesh; see
    test_sharded_emitter_recycles_with_absorption.)"""
    mesh = make_mesh()
    counts = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.020, seed=1, mesh=mesh,
                            capacity=16384 * 8, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, light.PhotonEmitterStep(10000, E=1.0))
        sign = light.ScatterSignMeasureStep(None, True)
        s.add_step(2, sign)
        s.add_photons(light.generate_photon_state(16384 * 8 - 25000, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        counts[fuse] = [int(r[1]) for r in sign.data]
    assert counts["auto"] == counts["off"]
    # two emissions fit (25000 // 10000), then the arena is full
    n0 = 16384 * 8 - 25000
    assert counts["auto"][:3] == [n0 + 10000, n0 + 20000, n0 + 20000]


def test_sharded_fused_trace_stream():
    """Stream planes (path trace) under shard_map: per-photon outputs stay
    sharded with the photons; the assembled matrix covers every shard."""
    import physicl_tpu.newton as newton

    mesh = make_mesh(8)
    N = 8 * 16384
    s = phys.Simulation(exit=lambda c: c.t >= 0.004, seed=0, mesh=mesh,
                        chunk_steps=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                             n=np.double(0.001)))
    tr = light.TracePathMeasureStep(None)
    s.add_step(3, tr)
    s.add_photons(light.generate_photon_state(N, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    ts, pos, alive, freq = tr.as_arrays()
    assert pos.shape == (4, 3, N)
    assert alive[:, :N].all()
    seg = np.diff(pos[:, :, :N], axis=0)
    d = np.linalg.norm(seg, axis=1)
    assert np.allclose(d, float(light.c) * 1e-3, rtol=2e-3)


@pytest.mark.slow
def test_sharded_emitter_recycles_with_absorption():
    """A sustained source + absorption on a mesh must keep emitting past the
    arena capacity (recycle compaction now runs on meshes), matching the
    single-device population trajectory."""
    def run(mesh):
        s = phys.Simulation(exit=lambda c: c.t >= 0.2, seed=0, mesh=mesh,
                            capacity=16384 * (8 if mesh else 1),
                            chunk_steps=8)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, light.PhotonEmitterStep(2000, E=2.0))
        s.add_step(2, phys.newton.NewtonianKinematicsStep())
        # pcoll ~= 0.3/iter: steady pop ~= 2000*0.7/0.3 ~= 4700
        s.add_step(3, light.ScatterDeleteStep(np.double(0.001),
                                              np.double(0.001)))
        sign = light.ScatterSignMeasureStep(None, True)
        s.add_step(4, sign)
        s.add_photons(light.generate_photon_state(1000, E=1.0))
        s.start(); s.join()
        assert s.used_fused
        return np.array([int(r[1]) for r in sign.data])

    ns_mesh = run(make_mesh())
    ns_single = run(None)
    assert len(ns_mesh) == len(ns_single) == 200
    # total emitted = 2000/iter x 200 iters = 400k >> capacity: the source
    # can only have kept emitting if slots recycled
    assert ns_mesh[-50:].min() > 3500, "mesh source starved"
    # same steady-state within binomial noise of independent streams
    tail_m, tail_s = ns_mesh[-50:].mean(), ns_single[-50:].mean()
    assert abs(tail_m - tail_s) < 0.05 * max(tail_m, tail_s)


@pytest.mark.slow
def test_mesh_midrun_injection():
    """Mid-run add_photons/add_obj now work on a mesh: injected at a chunk
    boundary, re-sharded, and counted exactly."""
    import time as _time

    mesh = make_mesh()
    s = phys.Simulation(exit=lambda c: c.t >= 0.5, seed=0, mesh=mesh,
                        chunk_steps=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=0.0005, n=0.001))
    sign = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(light.generate_photon_state(8 * 16384, E=1.0))
    s.start()
    _time.sleep(1.0)  # let the sharded kernel compile and run some chunks
    s.add_photons(light.generate_photon_state(500, E=2.0))
    s.add_obj(light.PhotonObject(
        E=np.double(3.0),
        v=np.array([float(light.c), 0, 0], dtype=np.double)))
    s.join()
    assert len(s.objects) == 8 * 16384 + 501
    ns = [int(r[1]) for r in sign.data]
    assert ns[-1] == 8 * 16384 + 501
    E = np.asarray(jax.device_get(s.sim_state.E))
    alive = np.asarray(jax.device_get(s.sim_state.alive))
    assert (E[alive] == 2.0).sum() == 500 and (E[alive] == 3.0).sum() == 1


@pytest.mark.parametrize("kind", ["hg", "rayl", "compton",
                                  "compton_thermal"])
@pytest.mark.slow
def test_sharded_fused_anisotropic_families(kind):
    """The anisotropic / energy-changing scatter ops shard like the rest of
    the family: fused on the mesh, defining angular moment preserved, and
    (compton) the recoil shift applied with the Compton edge respected
    globally across shards."""
    mesh = make_mesh()
    n = 8 * 4096
    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.001, seed=13, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        if kind == "hg":
            s.add_step(2, light.ScatterHenyeyGreensteinStep(A=1.0, n=1.0,
                                                            g=0.6))
        elif kind == "rayl":
            s.add_step(2, light.ScatterRayleighStep(A=1.0, n=1.0))
        elif kind == "compton_thermal":
            s.add_step(2, light.ScatterComptonStep(
                A=0.3 / (float(light.c) * 0.001), n=1.0, mec2=1e9,
                theta_e=0.01))
        else:
            s.add_step(2, light.ScatterComptonStep(A=1.0, n=1.0, mec2=0.5))
        s.add_photons(light.generate_photon_state(n, E=1.0))
        s.start(); s.join()
        assert s.used_fused
        v = np.asarray(jax.device_get(s.sim_state.v))[:, :n]
        E = np.asarray(jax.device_get(s.sim_state.E))[:n]
        res[m is not None] = (v[0] / float(light.c), E)
    for ct, E in res.values():
        if kind == "hg":
            assert abs(ct.mean() - 0.6) < 0.02        # <cos> == g
        elif kind == "rayl":
            assert abs((ct**2).mean() - 0.4) < 0.02   # <cos^2> == 2/5
        elif kind == "compton_thermal":
            scat = E != np.float32(1.0)
            assert 0.2 < scat.mean() < 0.4            # unsaturated pcoll
            gain = E[scat].mean() - 1.0               # Kompaneets 4theta_e
            assert abs(gain - 0.04) < 0.01, gain
        else:
            alpha = 2.0
            scat = E != np.float32(1.0)
            assert scat.mean() > 0.99
            pred = 1.0 / (1.0 + alpha * (1.0 - ct[scat]))
            np.testing.assert_allclose(E[scat], pred, atol=3e-5, rtol=3e-5)
            assert E.min() >= 1.0 / (1.0 + 2 * alpha) - 1e-6
    # mesh vs single: same distribution, different RNG partitioning
    a, b = res[True], res[False]
    assert abs(a[0].mean() - b[0].mean()) < 0.02
    assert abs(a[1].mean() - b[1].mean()) < 0.01


def test_sharded_fresnel_interface():
    """RefractiveInterfaceStep under shard_map: deterministic TIR is exact
    on every shard; stochastic reflectance matches the single-device run."""
    mesh = make_mesh()
    n = 8 * 4096
    c = float(light.c)
    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.001, seed=21, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.RefractiveInterfaceStep(0.0, 1.0, 1.5))
        d = np.array([0.0, 0.0, 1.0])
        s.add_photons(light.generate_photon_state(
            n, E=1.0, v=d * c, r=np.array([0.0, 0.0, -1e5])))
        s.start(); s.join()
        assert s.used_fused
        v = np.asarray(jax.device_get(s.sim_state.v))[:, :n]
        res[m is not None] = (v[2] < 0).mean()
    # R(0 deg, 1->1.5) = 0.04; mesh and single within binomial noise
    for frac in res.values():
        assert abs(frac - 0.04) < 0.006, res
    assert abs(res[True] - res[False]) < 0.008


def test_sharded_weighted_transport_psum():
    """Implicit-capture weight sums cross the 8-device mesh as one psum and
    stay deterministic-exact (N*(1-p)^k), shard-independent."""
    mesh = make_mesh()
    n = 8 * 16384
    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.005, seed=0, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        c = float(light.c)
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(0.25 / (c * 1e-3)),
            implicit_capture=True))
        red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                     outputs=("W",), measure_n=True)
        s.add_step(3, red)
        s.add_photons(light.generate_photon_state(n, E=1.0))
        s.start(); s.join()
        assert s.used_fused
        res[m is not None] = np.array(red.data, dtype=float)
    for rows in res.values():
        assert (rows[:, 1] == n).all()
        expect = n * 0.75 ** np.arange(1, rows.shape[0] + 1)
        np.testing.assert_allclose(rows[:, 2], expect, rtol=1e-4)
    # capture is draw-free, so mesh and single-device agree to roundoff
    np.testing.assert_allclose(res[True][:, 2], res[False][:, 2], rtol=1e-5)


def test_sharded_fused_lorentz_charged_population():
    """The charged-particle fused path under shard_map: Boris dynamics is
    deterministic, so the mesh run must match the single-device run
    per-particle (bulk generic population via generate_particle_state)."""
    mesh = make_mesh()
    n = 8 * 2048
    rng = np.random.default_rng(11)
    v0 = rng.normal(size=(3, n))
    r0 = rng.normal(size=(3, n)) * 0.01
    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.05, seed=2, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.LorentzForceStep(
            E_field=(0.5, 0.0, 0.2), B_field=(0.0, 0.0, 60.0), q_over_m=1.0))
        s.add_step(2, phys.newton.NewtonianKinematicsStep())
        s.add_particles(phys.newton.generate_particle_state(n, v=v0, r=r0))
        s.start(); s.join()
        assert s.used_fused, s.explain_plan()
        res[m is not None] = (
            np.asarray(jax.device_get(s.sim_state.r))[:, :n],
            np.asarray(jax.device_get(s.sim_state.v))[:, :n])
    np.testing.assert_allclose(res[True][0], res[False][0],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res[True][1], res[False][1],
                               rtol=1e-6, atol=1e-7)


def test_sharded_fused_lorentz_per_particle_qm():
    """Per-particle q/m (packed extras plane) under shard_map: the derived
    qm plane shards with the particles; mesh matches single-device and
    opposite charges stay mirror images."""
    mesh = make_mesh()
    vv = phys.Measurement([5.0, 0, 0], "m**1 s**-1")
    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.05, seed=4, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.LorentzForceStep(B_field=(0, 0, 200.0)))
        s.add_step(2, phys.newton.NewtonianKinematicsStep())
        for i in range(64):
            s.add_obj(phys.newton.ChargedObject(
                q=(1.0 if i % 2 == 0 else -1.0), m=1.0, v=vv))
        s.start(); s.join()
        assert s.used_fused, s.explain_plan()
        res[m is not None] = np.asarray(
            jax.device_get(s.sim_state.v))[:, :64]
    np.testing.assert_allclose(res[True], res[False], rtol=1e-6, atol=1e-7)
    v = res[True]
    np.testing.assert_allclose(v[1, 0::2], -v[1, 1::2], rtol=1e-5)


def test_functional_scan_on_sharded_state():
    """functional.scan_steps is pure jax: with particle-sharded input state
    it runs SPMD over the mesh (no shard_map needed) and matches the
    unsharded run exactly for deterministic dynamics."""
    from physicl_tpu import functional
    from physicl_tpu.state import SimState

    mesh = make_mesh()
    n = 8 * 2048
    rng = np.random.default_rng(3)
    v0 = rng.normal(size=(3, n))
    state = SimState.from_population(
        [], [physicl_tpu.newton.generate_particle_state(n, v=v0)])

    def run(st):
        steps = [phys.UpdateTimeStep(lambda x: 1e-3),
                 physicl_tpu.newton.LorentzForceStep(
                     E_field=(0.5, 0, 0), B_field=(0, 0, 60.0),
                     q_over_m=1.0),
                 physicl_tpu.newton.NewtonianKinematicsStep()]
        return functional.scan_steps(steps, st, 50)

    out_plain = run(state)
    out_mesh = run(shard_state(state, mesh))
    assert len(out_mesh.r.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(jax.device_get(out_mesh.r)),
                               np.asarray(jax.device_get(out_plain.r)),
                               rtol=1e-6, atol=1e-7)


def test_sharded_custom_step_extras_planes():
    """ElementwiseStep/ReduceMeasureStep extras= planes pack and shard with
    the particle axis: deterministic per-particle decay driven by an extras
    plane matches the unsharded run exactly, and the extras-tally psum is
    global."""
    import jax.numpy as jnp

    mesh = make_mesh()
    n = 8 * 2048
    rng = np.random.default_rng(11)
    tau = rng.uniform(0.5, 4.0, n)

    res = {}
    for m in (mesh, None):
        s = phys.Simulation(until_t=0.005, seed=0, mesh=m)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.ElementwiseStep(
            lambda p: {"E": p.E * jnp.exp(-p.extras["tau"] * p.dt)},
            extras=("tau",)))
        red = phys.ReduceMeasureStep(
            None, lambda p: {"Etau": p.E * p.extras["tau"]},
            outputs=("Etau",), extras=("tau",))
        s.add_step(3, red)
        s.add_photons(light.generate_photon_state(
            n, E=1.0, extras={"tau": tau}))
        s.start(); s.join()
        assert s.used_fused
        res[m is not None] = (np.asarray(s.sim_state.E)[:n],
                              np.array([r[1] for r in red.data]))
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-5)
    np.testing.assert_allclose(res[True][1], res[False][1], rtol=1e-5)
    # first-iteration tally is the closed form sum(tau * exp(-tau dt))
    np.testing.assert_allclose(
        res[False][1][0], float((tau * np.exp(-tau * 1e-3)).sum()),
        rtol=1e-4)


def test_checkpoint_reshard_8_to_1_to_4_and_back(tmp_path):
    """Elastic restart (r4 VERDICT item): a checkpoint written under the
    8-device mesh resumes on 1 device and on a 4-device mesh (and a
    1-device checkpoint resumes on 8) with identical measured physics —
    the implicit-capture decay is deterministic, so the surviving
    photons' weights/positions must match the uninterrupted mesh run
    exactly."""
    c_dt = float(light.c) * 0.001
    A = 0.2 / c_dt
    nfn = light.layered_density(
        np.array([0.5, 3.5, 6.5]) * c_dt, [1.0, 2.0])

    def build(t_end, mesh, restore=None, capacity=None):
        s = phys.Simulation(until_t=t_end * 0.9999, seed=0, mesh=mesh,
                            capacity=capacity)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        if restore is None:
            s.add_photons(light.generate_photon_state(512, E=1.0))
        else:
            s.restore_checkpoint(restore)
        return s

    # uninterrupted 8-device reference
    ref = build(0.008, make_mesh())
    ref.start(); ref.join()
    w_ref = np.asarray(jax.device_get(ref.sim_state.w), np.float64)[:512]
    r_ref = np.asarray(jax.device_get(ref.sim_state.r),
                       np.float64)[:, :512]

    # 8-device run to t=0.004, checkpoint (capacity = 8 shard units)
    first = build(0.004, make_mesh())
    first.start(); first.join()
    ck = str(tmp_path / "mesh8.npz")
    first.save_checkpoint(ck)

    for mesh in (None, make_mesh(4)):
        resumed = build(0.008, mesh, restore=ck)
        resumed.start(); resumed.join()
        assert resumed.sim_state.capacity % max(
            1, (mesh.devices.size if mesh else 1)) == 0
        w = np.asarray(jax.device_get(resumed.sim_state.w),
                       np.float64)[:512]
        r = np.asarray(jax.device_get(resumed.sim_state.r),
                       np.float64)[:, :512]
        np.testing.assert_array_equal(w, w_ref)
        np.testing.assert_array_equal(r, r_ref)
        assert len(resumed.ts) == len(ref.ts) == 8

    # and the reverse: a single-device checkpoint grows onto 8 devices
    solo = build(0.004, None)
    solo.start(); solo.join()
    ck1 = str(tmp_path / "solo.npz")
    solo.save_checkpoint(ck1)
    grown = build(0.008, make_mesh(), restore=ck1)
    grown.start(); grown.join()
    # capacity re-padded to the 8-device tile-aligned shard unit
    from physicl_tpu.state import pad_capacity
    assert grown.sim_state.capacity % (pad_capacity(1) * 8) == 0
    w = np.asarray(jax.device_get(grown.sim_state.w), np.float64)[:512]
    np.testing.assert_array_equal(w, w_ref)


def test_checkpoint_shrink_refuses_when_slots_used(tmp_path):
    """Shrinking a restore below the snapshot's high-water mark (or any
    live slot) raises instead of silently truncating particles."""
    import pytest as _pytest
    from physicl_tpu.utils.checkpoint import load_checkpoint, repad_state

    s = phys.Simulation(until_t=0.002 * 0.9999, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(300, E=1.0))
    s.start(); s.join()
    ck = str(tmp_path / "solo.npz")
    s.save_checkpoint(ck)
    state, meta = load_checkpoint(ck)
    with _pytest.raises(ValueError, match="shrink"):
        repad_state(state, 128, hwm=meta["hwm"])
    # growth then legal shrink back round-trips exactly
    big = repad_state(state, 4096, hwm=meta["hwm"])
    back = repad_state(big, state.capacity, hwm=meta["hwm"])
    np.testing.assert_array_equal(np.asarray(back.w),
                                  np.asarray(state.w))
    np.testing.assert_array_equal(np.asarray(back.alive),
                                  np.asarray(state.alive))
