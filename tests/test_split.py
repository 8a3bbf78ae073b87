"""Population-control variance reduction: ImportanceSplitStep /
WeightWindowStep (extension — the reference has no variance reduction;
these complete the MCNP-style toolkit next to implicit capture, roulette,
and source biasing).

The load-bearing invariant: a split replaces one particle of weight w with
n of weight w/n, so TOTAL statistical weight is conserved EXACTLY per event
— deterministic weighted observables are bit-level unaffected while the
sample count at depth grows. Tests pin that exactly (roulette off), pin
unbiasedness statistically (roulette on), and pin capacity-clip safety.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

C_CODE = float(light.c)
DT = 1e-3


def _base(n_photons, capacity, seed=0, T=0.02, **kw):
    s = phys.Simulation(until_t=T * 0.9999, seed=seed, capacity=capacity,
                        **kw)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(n_photons, E=1.0))
    return s


def _wsum(s):
    st = s.sim_state
    w = np.asarray(st.w, np.float64)
    alive = np.asarray(st.alive)
    return float(w[alive].sum()), int(alive.sum())


def test_split_conserves_total_weight_exactly():
    """Importance doubles every flight segment -> every particle splits in
    2 each iteration; sum(w) is conserved to f32 roundoff and the
    population multiplies."""
    s = _base(64, capacity=65536, T=0.005)
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (C_CODE * DT) + 0.5),
        roulette=False))
    s.start(); s.join()
    wsum, n = _wsum(s)
    assert n == 64 * 2 ** 5  # 5 iterations, clean doubling
    np.testing.assert_allclose(wsum, 64.0, rtol=1e-5)
    w = np.asarray(s.sim_state.w)[np.asarray(s.sim_state.alive)]
    np.testing.assert_allclose(w, 1.0 / 2 ** 5, rtol=1e-6)


def test_split_does_not_change_implicit_capture_observable():
    """Splitting + implicit capture: the weighted survival SUM equals the
    analytic N*(1-p)^k exactly (f32 roundoff) — the deterministic
    observable is unaffected by population control."""
    p = 0.02
    k = 20
    A = np.double(p / (C_CODE * DT))
    ref = phys.Simulation(until_t=DT * k * 0.9999, seed=1, capacity=16384)
    ref.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    ref.add_step(1, phys.newton.NewtonianKinematicsStep())
    ref.add_step(2, light.ScatterDeleteStep(A, np.double(1.0),
                                            implicit_capture=True))
    ref.add_photons(light.generate_photon_state(256, E=1.0))
    ref.start(); ref.join()

    s = _base(256, capacity=65536, seed=1, T=DT * k)
    s.add_step(2, light.ScatterDeleteStep(A, np.double(1.0),
                                          implicit_capture=True))
    s.add_step(3, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (4 * C_CODE * DT)),
        roulette=False))
    s.start(); s.join()

    w_ref, n_ref = _wsum(ref)
    w_spl, n_spl = _wsum(s)
    expect = 256 * (1 - p) ** k
    np.testing.assert_allclose(w_ref, expect, rtol=1e-4)
    np.testing.assert_allclose(w_spl, expect, rtol=1e-4)
    assert n_spl > 4 * n_ref  # population control actually grew the sample


def test_capacity_clipping_keeps_weight_conserved():
    """When the arena fills, copies that don't fit are not created and the
    survivor keeps the larger share — total weight still exact."""
    s = _base(128, capacity=16384, T=0.02)  # 128 * 2^20 >> capacity
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (C_CODE * DT) + 0.5),
        roulette=False))
    s.start(); s.join()
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 128.0, rtol=1e-4)
    assert n == 16384  # arena exactly full


def test_max_split_caps_copies():
    s = _base(64, capacity=65536, T=0.002)  # one split iteration
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: jnp.where(x > 0, 100.0, 1.0), max_split=4,
        roulette=False))
    s.start(); s.join()
    wsum, n = _wsum(s)
    # q = I(r)/I(r-dr) fires only on the 0 -> x>0 crossing (ratio-based:
    # staying inside the high-importance region is q = 1), capped at 4
    assert n == 64 * 4
    np.testing.assert_allclose(wsum, 64.0, rtol=1e-5)


def test_roulette_unbiased_in_expectation():
    """Down-importance roulette: E[sum w] is conserved (statistical)."""
    s = _base(20000, capacity=32768, T=0.005, seed=7)
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 0.5 ** jnp.floor(x / (C_CODE * DT) + 0.5)))
    s.start(); s.join()
    wsum, n = _wsum(s)
    # 5 halvings: population ~ 20000/32, weights ~ 32
    assert n < 20000 / 16
    np.testing.assert_allclose(wsum, 20000.0, rtol=0.05)


def test_weight_window_splits_heavy_sources():
    """Source-biased photons (w=32) split down into the window."""
    s = phys.Simulation(until_t=0.003 * 0.9999, seed=3, capacity=65536)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.WeightWindowStep(w_lo=0.25, w_hi=4.0, w_target=1.0,
                                         max_split=16))
    s.add_photons(light.generate_photon_state(100, E=1.0, w=32.0))
    s.start(); s.join()
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 3200.0, rtol=1e-4)
    w = np.asarray(s.sim_state.w)[np.asarray(s.sim_state.alive)]
    # q = 32 capped at max_split=16 -> one split to w = 2, which is inside
    # the window (<= w_hi = 4): population x16, weights in-band, sum exact
    assert n == 1600 and np.all(w <= 4.0) and np.all(w >= 0.25)
    np.testing.assert_allclose(w, 2.0)


def test_weight_window_validation():
    with pytest.raises(ValueError):
        light.WeightWindowStep(w_lo=2.0, w_hi=1.0)
    with pytest.raises(TypeError):
        light.ImportanceSplitStep(importance=3.0)
    with pytest.raises(ValueError):
        light.ImportanceSplitStep(lambda x, y, z: 1.0, max_split=1)


def test_split_runs_generic_with_structured_refusal():
    s = _base(64, capacity=16384, T=0.002)
    s.add_step(2, light.ImportanceSplitStep(lambda x, y, z: 1.0))
    s.start(); s.join()
    assert not s.used_fused
    rep = s.explain_plan()
    assert "ImportanceSplitStep" in str(rep)


def test_split_copies_inherit_kinematics():
    """Copies keep flying: after a split, both original and copies advance
    (r grows) and carry the source's velocity/energy."""
    s = _base(32, capacity=16384, T=0.004)
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: jnp.where((x > C_CODE * DT * 1.5)
                                 & (x < C_CODE * DT * 2.5), 2.0, 1.0),
        roulette=False))
    s.start(); s.join()
    st = s.sim_state
    alive = np.asarray(st.alive)
    assert alive.sum() == 64
    rx = np.asarray(st.r)[0][alive]
    E = np.asarray(st.E)[alive]
    # copies made at iteration 2 continue to t=4*dt... all at 4 flight steps
    np.testing.assert_allclose(rx, 4 * C_CODE * DT, rtol=1e-5)
    np.testing.assert_allclose(E, 1.0)


@pytest.mark.slow
def test_split_on_sharded_mesh_conserves_weight():
    """Splitting under a particle-sharded mesh: the contiguous-slot prefix
    sum crosses shard boundaries; weight conservation stays exact."""
    import jax
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from physicl_tpu.parallel import make_mesh
    s = _base(1024, capacity=131072, T=0.005, mesh=make_mesh())
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (C_CODE * DT) + 0.5),
        roulette=False))
    s.start(); s.join()
    wsum, n = _wsum(s)
    assert n == 1024 * 2 ** 5
    np.testing.assert_allclose(wsum, 1024.0, rtol=1e-5)


@pytest.mark.slow
def test_chunk_boundary_importance_split_keeps_fused():
    """ImportanceSplitStep(at='chunk'): the transport chunk runs the FUSED
    kernel; splitting applies between dispatches against the last-boundary
    position snapshot. Importance doubles every chunk's flight distance,
    so each interior boundary doubles the population at w/2 — total weight
    exact, fused plan retained."""
    K = 16  # iterations per dispatch
    s = phys.Simulation(until_t=4 * K * DT * 0.9999, seed=0,
                        capacity=65536, chunk_steps=K)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (K * C_CODE * DT) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(light.generate_photon_state(512, E=1.0))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    wsum, n = _wsum(s)
    # boundaries fire after chunks 1..3 (none after the final chunk)
    assert n == 512 * 2 ** 3
    np.testing.assert_allclose(wsum, 512.0, rtol=1e-5)


def test_chunk_boundary_window_keeps_fused():
    """WeightWindowStep(at='chunk') + analog absorption stays fused; the
    heavy source splits into the band at the first interior boundary."""
    K = 8
    s = phys.Simulation(until_t=3 * K * DT * 0.9999, seed=2,
                        capacity=65536, chunk_steps=K)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(np.double(0.0), np.double(0.0)))
    s.add_step(3, light.WeightWindowStep(0.25, 4.0, w_target=1.0,
                                         max_split=16, at="chunk"))
    s.add_photons(light.generate_photon_state(100, E=1.0, w=32.0))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 3200.0, rtol=1e-4)
    w = np.asarray(s.sim_state.w)[np.asarray(s.sim_state.alive)]
    assert n == 1600 and np.all(w == 2.0)  # 32 -> 16 copies at w=2


@pytest.mark.slow
def test_chunk_boundary_matches_per_step_on_smooth_importance():
    """For a ballistic beam the chunk-boundary ratio telescopes: splitting
    against the boundary snapshot gives the same total weight and (for
    chunk-aligned importance surfaces) the same final population as
    per-step application."""
    K = 8
    imp = lambda x, y, z: 2.0 ** jnp.floor(x / (K * C_CODE * DT) + 0.5)
    pops = {}
    for at in ("step", "chunk"):
        s = phys.Simulation(until_t=3 * K * DT * 0.9999, seed=4,
                            capacity=65536, chunk_steps=K)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ImportanceSplitStep(imp, roulette=False, at=at))
        s.add_photons(light.generate_photon_state(256, E=1.0))
        s.start(); s.join()
        pops[at] = _wsum(s)
    assert pops["step"][0] == pytest.approx(256.0, rel=1e-5)
    assert pops["chunk"][0] == pytest.approx(256.0, rel=1e-5)
    # the importance steps at x = 4, 12, 20 flight steps (the +0.5 shift):
    # per-step application sees all 3 crossings; chunk mode credits climbs
    # at boundaries x = 8, 16 only (the pass after the final chunk is
    # suppressed — the run is over), so it lags by the last crossing
    assert pops["step"][1] == 256 * 2 ** 3
    assert pops["chunk"][1] == 256 * 2 ** 2


def test_at_validation():
    with pytest.raises(ValueError, match="at"):
        light.WeightWindowStep(0.5, 2.0, at="sometimes")


def test_no_boundary_pass_after_final_iteration_host_exact():
    """Review fix: on the generic HOST-EXACT path (chunk=1) the boundary
    pass must not run after the final iteration — the exit check happens
    before maintenance, matching the fused path's exit_pending guard."""
    K = 5
    s = phys.Simulation(
        exit=lambda c: c.t >= K * DT * 0.9999 and len(c.objects) > -1,
        seed=0, capacity=65536)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (C_CODE * DT) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(light.generate_photon_state(16, E=1.0))
    s.start(); s.join()
    assert not s.used_fused
    wsum, n = _wsum(s)
    # host-exact => one boundary per iteration: splits before iterations
    # 2..K only (primed snapshot makes the first pass a no-op, and the
    # pass after iteration K is suppressed by the pre-maintain exit check)
    assert n == 16 * 2 ** (K - 1)
    np.testing.assert_allclose(wsum, 16.0, rtol=1e-5)


def test_chunk_boundary_generic_matches_fused_population():
    """Review fix: a declared t-exit landing exactly on a chunk edge must
    not trigger a trailing boundary pass on the generic path either — the
    fused and generic runs of the same at='chunk' config end with the
    same population law."""
    K = 16
    pops = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=3 * K * DT * 0.9999, seed=1,
                            capacity=65536, chunk_steps=K, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ImportanceSplitStep(
            lambda x, y, z: 2.0 ** jnp.floor(x / (K * C_CODE * DT) + 0.5),
            roulette=False, at="chunk"))
        s.add_photons(light.generate_photon_state(64, E=1.0))
        s.start(); s.join()
        assert (s.used_fused) == (fuse == "auto")
        pops[fuse] = _wsum(s)
    assert pops["auto"][1] == pops["off"][1] == 64 * 2 ** 2
    assert pops["auto"][0] == pytest.approx(64.0, rel=1e-5)
    assert pops["off"][0] == pytest.approx(64.0, rel=1e-5)


@pytest.mark.slow
def test_chunk_boundary_split_on_sharded_mesh():
    """Review fix: at='chunk' under a particle-sharded mesh re-shards the
    state after each boundary pass; weight stays exactly conserved."""
    import jax
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from physicl_tpu.parallel import make_mesh
    K = 16
    s = phys.Simulation(until_t=3 * K * DT * 0.9999, seed=5,
                        capacity=131072, chunk_steps=K, mesh=make_mesh())
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (K * C_CODE * DT) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(light.generate_photon_state(1024, E=1.0))
    s.start(); s.join()
    wsum, n = _wsum(s)
    assert n == 1024 * 2 ** 2
    np.testing.assert_allclose(wsum, 1024.0, rtol=1e-5)


def test_split_checkpoint_resume_conserves_weight(tmp_path):
    """Checkpoint/resume across an at='chunk' split run: the boundary
    snapshot is step-local state NOT in the checkpoint — the resumed run
    re-primes from the restored positions (documented: at most one chunk
    of splitting deferred) and total weight stays exactly conserved."""
    K = 8
    imp = lambda x, y, z: 2.0 ** jnp.floor(x / (K * C_CODE * DT) + 0.5)
    ckpt = str(tmp_path / "split.npz")

    def build(T, restore=None):
        s = phys.Simulation(until_t=T * 0.9999, seed=9, capacity=65536,
                            chunk_steps=K)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ImportanceSplitStep(imp, roulette=False,
                                                at="chunk"))
        if restore is None:
            s.add_photons(light.generate_photon_state(128, E=1.0))
        else:
            s.restore_checkpoint(restore)
        return s

    b1 = build(2 * K * DT)
    b1.start(); b1.join()
    b1.save_checkpoint(ckpt)
    w1, n1 = _wsum(b1)
    assert n1 == 128 * 2  # one interior boundary so far

    b2 = build(4 * K * DT, restore=ckpt)
    b2.start(); b2.join()
    w2, n2 = _wsum(b2)
    np.testing.assert_allclose(w2, 128.0, rtol=1e-5)
    # resumed run re-primes at t=2K (one boundary of splitting deferred),
    # then doubles at its remaining interior boundary
    assert n2 == 128 * 2 * 2
