"""Plan observability: structured fused-prover refusal reasons,
``sim.explain_plan()``, one-time fallback warnings, and the declared exit
fast paths ``Simulation(until_t=...)`` / ``Simulation(exit="extinction")``.

The reference made its backend split explicit through the ``cl_on`` switch
(physicl/__init__.py:413); our fused/generic/host-exact split spans a far
wider performance range, so every planning decision must be visible.
"""

import warnings

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton


def _base_sim(**kw):
    kw.setdefault("exit", lambda c: c.t >= 0.003)
    kw.setdefault("seed", 0)
    s = phys.Simulation(**kw)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    return s


def _refusal_codes(sim):
    assert sim.plan_report is not None
    return [code for code, _ in sim.plan_report.refusals]


def _run(sim, photons=64):
    if photons:
        sim.add_photons(light.generate_photon_state(photons, E=1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim.start()
        sim.join()
    return sim


def test_fused_plan_reports_fused_mode():
    s = _run(_base_sim())
    assert s.used_fused
    assert s.plan_report.mode == "fused"
    assert s.plan_report.refusals == []
    text = s.explain_plan()
    assert "fused" in text and "fused chunk builder: xla" in text
    assert s.plan_report.builder == "xla"


def test_refusal_extras_missing():
    """A custom step declaring an extras plane the population does not carry
    refuses fusion with a structured reason; the generic path then raises
    the instructive error at first apply."""
    s = _base_sim()
    s.add_step(2, phys.ElementwiseStep(lambda p: {"E": p.E},
                                       extras=("nope",)))
    with pytest.raises(ValueError, match="carries no 'nope'"):
        _run(s)
    assert "extras-missing" in _refusal_codes(s)
    assert "nope" in s.explain_plan()


def test_refusal_unsupported_step():
    class WeirdStep(phys.Step):
        def apply(self, state, ctx):
            return state

    s = _base_sim()
    s.add_step(2, WeirdStep())
    _run(s)
    assert not s.used_fused
    assert "unsupported-step" in _refusal_codes(s)
    assert "WeirdStep" in s.explain_plan()


def test_mixed_population_fuses_with_otype_plane():
    """Photons + a generic particle: the packed otype plane gates photon
    physics per particle, so mixed populations fuse too."""
    s = _base_sim()
    s.add_obj(phys.Object(v=phys.Measurement([1.0, 0, 0], "m**1 s**-1")))
    _run(s)  # adds 64 photons alongside the generic object
    assert s.used_fused
    assert s.plan_report.mode == "fused"


def test_emitter_in_mixed_population_fuses_and_retypes():
    """PhotonEmitterStep in a MIXED population fuses: emission retypes the
    slots to photons through the packed otype plane (kernel side) and in
    state.otype (host side); the deterministic population schedule is exact
    on both paths."""
    import jax

    for fuse in ("auto", "off"):
        s = _base_sim(fuse=fuse)
        s.add_step(2, light.PhotonEmitterStep(16, E=1.0))
        s.add_obj(phys.Object(v=phys.Measurement([1.0, 0, 0], "m**1 s**-1")))
        _run(s)
        assert s.used_fused == (fuse == "auto")
        k = len(s.ts)
        st = s.sim_state
        otype = np.asarray(jax.device_get(st.otype))
        alive = np.asarray(jax.device_get(st.alive))
        n0 = 65  # 64 photons + 1 generic object
        assert alive.sum() == n0 + 16 * k
        # every emitted slot is a photon on BOTH paths
        assert (otype[alive][n0:] == 1).all()


def test_generic_single_species_fuses():
    """An all-generic population with species-agnostic steps fuses (the
    charged/massive-particle fused path)."""
    s = _base_sim()
    s.add_obj(phys.Object(v=phys.Measurement([1.0, 0, 0], "m**1 s**-1")))
    _run(s, photons=0)
    assert s.used_fused
    assert s.plan_report.mode == "fused"


def test_refusal_photon_only_op_in_generic_population():
    """Photon physics (otype-filtered no-ops on a generic population) keeps
    the sim on the generic path, with the reason named."""
    s = _base_sim()
    s.add_step(2, light.ScatterIsotropicStep(n=1e-3, A=1e-3))
    s.add_obj(phys.Object(v=phys.Measurement([1.0, 0, 0], "m**1 s**-1")))
    _run(s, photons=0)
    assert not s.used_fused
    assert "photon-only-op" in _refusal_codes(s)
    assert "ScatterIsotropicStep" in s.explain_plan()


def test_refusal_empty_population():
    s = _base_sim()
    _run(s, photons=0)
    assert "empty-population" in _refusal_codes(s)


def test_refusal_dt_fn_not_t_only():
    s = phys.Simulation(exit=lambda c: c.t >= 0.003, seed=0)
    s.add_step(0, phys.UpdateTimeStep(
        lambda x: 0.001 + 0.0 * x.n_objects))  # reads beyond (t, dt)
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    _run(s)
    assert "dt-fn-not-t-only" in _refusal_codes(s)


def test_refusal_duplicate_update_step():
    s = _base_sim()
    s.add_step(2, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    _run(s)
    assert "duplicate-update-step" in _refusal_codes(s)


def test_refusal_no_update_step():
    s = phys.Simulation(exit="extinction", seed=0)
    s.add_step(0, phys.newton.NewtonianKinematicsStep())
    s.add_step(1, light.ScatterDeleteStep(n=np.double(20.0),
                                          A=np.double(20.0)))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    # don't run: with dt pinned at 0 nothing moves, so extinction never
    # fires — plan without starting
    s.explain_plan()
    assert "no-update-step" in _refusal_codes(s)


def test_explain_plan_prestart_does_not_pin_state():
    """A pre-start explain_plan() materializes the initial arena only
    transiently: it must not stay pinned in ``sim.sim_state`` — the real
    run allocates its own arena in run(), and holding both doubles peak
    HBM (round-3 code-review finding). The subsequent run is unaffected."""
    s = _base_sim()
    s.add_photons(light.generate_photon_state(64, E=1.0))
    assert s.sim_state is None
    text = s.explain_plan()
    assert "fused" in text
    assert s.sim_state is None  # dry-pass arena dropped, not pinned
    _run(s, photons=0)
    assert s.used_fused and len(s.ts) == 3


def test_refusal_emitter_sampler_without_icdf():
    s = _base_sim()
    s.add_step(2, light.PhotonEmitterStep(4, E=lambda key, k: np.ones(k)))
    _run(s)
    assert "emitter-sampler" in _refusal_codes(s)


def test_refusal_extinction_without_death():
    s = phys.Simulation(exit="extinction", seed=0, until_t=None)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(64, E=1.0))
    # don't run (it would never exit); plan without starting
    text = s.explain_plan()
    assert "extinction-without-death" in text
    assert "extinction-without-death" in _refusal_codes(s)


def test_refusal_extinction_with_emitter():
    s = phys.Simulation(exit="extinction", seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(n=np.double(2.0), A=np.double(2.0)))
    s.add_step(3, light.PhotonEmitterStep(2, E=1.0))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    text = s.explain_plan()
    assert "extinction-with-emitter" in text


def test_refusal_jit_off():
    s = _base_sim(jit_on=False)
    _run(s)
    assert "jit-off" in _refusal_codes(s)


def test_refusal_unclassifiable_exit_predicate():
    s = _base_sim(exit=lambda x: len(x.objects) < 32)
    # strong absorption so the count-threshold predicate actually fires
    s.add_step(2, light.ScatterDeleteStep(n=np.double(0.01),
                                          A=np.double(0.001)))
    _run(s)
    assert "exit-predicate" in _refusal_codes(s)
    assert s.plan_report.mode == "host-exact"
    assert s.chunk_used == 1
    assert "host-exact" in s.explain_plan()


def test_fallback_warning_fires_once():
    class WeirdStep(phys.Step):
        def apply(self, state, ctx):
            return state

    s = _base_sim()
    s.add_step(2, WeirdStep())
    s.add_photons(light.generate_photon_state(64, E=1.0))
    with pytest.warns(RuntimeWarning, match="unsupported-step"):
        s.start()
        s.join()
    assert s._warned_fallback


def test_host_exact_warning_names_the_fix():
    s = _base_sim(exit=lambda x: len(x.objects) < 32)
    s.add_step(2, light.ScatterDeleteStep(n=np.double(0.01),
                                          A=np.double(0.001)))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    with pytest.warns(RuntimeWarning, match="until_t"):
        s.start()
        s.join()


def test_explain_plan_before_start_is_silent_and_nondestructive():
    s = _base_sim()
    s.add_photons(light.generate_photon_state(64, E=1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning fails the test
        text = s.explain_plan()
    assert "fused" in text
    # the dry planning pass must not break the subsequent real run
    s.start(); s.join()
    assert s.used_fused
    assert len(s.ts) == 3


def test_until_t_declared_exit_fuses_and_matches_lambda():
    out = {}
    for mode in ("until", "lambda"):
        if mode == "until":
            s = phys.Simulation(until_t=0.005, seed=3)
        else:
            s = phys.Simulation(exit=lambda c: c.t >= 0.005, seed=3)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterSphericalStep(A=0.5, n=0.5))
        s.add_photons(light.generate_photon_state(256, E=1.0))
        s.start(); s.join()
        assert s.used_fused
        out[mode] = (list(s.ts), np.asarray(s.sim_state.r))
    assert out["until"][0] == out["lambda"][0]
    np.testing.assert_array_equal(out["until"][1], out["lambda"][1])


def test_extinction_string_exit_runs_to_extinction():
    s = phys.Simulation(exit="extinction", seed=1)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(n=np.double(5.0), A=np.double(5.0)))
    s.add_photons(light.generate_photon_state(512, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    assert len(s.objects) == 0


def test_declared_exit_skips_probing_impure_predicates():
    """An impure predicate fires during empirical probing (VERDICT weak #2);
    a declared UntilT/ExtinctionExit must never be probed. We verify by
    counting calls before the run starts: planning with a declared exit
    calls the predicate zero times."""
    calls = []

    class CountingUntil(phys.engine.UntilT):
        def __call__(self, view):
            calls.append(1)
            return super().__call__(view)

    s = phys.Simulation(exit=CountingUntil(0.003), seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(64, E=1.0))
    s.explain_plan()
    # t-mode host scheduling legitimately evaluates the predicate when the
    # run executes, but PLANNING must not probe it with synthetic views
    assert calls == []


def test_until_t_and_exit_are_mutually_exclusive():
    with pytest.raises(ValueError, match="not both"):
        phys.Simulation(until_t=0.1, exit=lambda c: c.t >= 0.2)


def test_unknown_exit_string_raises():
    with pytest.raises(ValueError, match="extinction"):
        phys.Simulation(exit="when-done")


def test_generic_path_report_when_fuse_off():
    s = _base_sim(fuse="off")
    _run(s)
    assert s.plan_report.mode == "generic"
    assert s.plan_report.refusals == []
    assert "fuse" in s.explain_plan()


@pytest.mark.slow
def test_report_names_chunk_boundary_steps():
    """at='chunk' population control shows up in explain_plan on both the
    fused and generic plans (the prover skips the step, so the report is
    the only surface that says where it went)."""
    import jax.numpy as jnp
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.002, seed=0, capacity=16384,
                            fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.WeightWindowStep(0.5, 2.0, at="chunk"))
        s.add_photons(light.generate_photon_state(64, E=1.0))
        s.start(); s.join()
        rep = str(s.explain_plan())
        assert "WeightWindowStep" in rep and "boundary" in rep, rep
