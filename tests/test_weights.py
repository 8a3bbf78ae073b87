"""Weighted (non-analog) Monte Carlo transport: the statistical-weight plane,
implicit capture (survival biasing), Russian roulette, and weighted tallies.

The reference is purely analog (a photon either survives or is deleted,
physicl/light.py:146-158); weights are a extension. Key invariants:

* implicit capture is DETERMINISTIC: a monoenergetic beam in a uniform
  absorber has total weight exactly N*(1-p)^k after k iterations — both
  execution paths must hit it to f32 roundoff, no statistical tolerance;
* roulette conserves expected weight (unbiased) while bounding the alive
  population's minimum weight away from zero;
* weighted tallies (SpectrumMeasureStep(weighted=True), p.w in
  ReduceMeasureStep) replace counts as the physical observable.
"""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def _absorber(fuse, n_phot=4096, p_step=0.1, t_end=0.02, seed=0, **del_kw):
    s = phys.Simulation(until_t=t_end, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    c = float(light.c)
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(p_step / (c * 1e-3)), **del_kw))
    s.add_photons(light.generate_photon_state(n_phot, E=1.0))
    return s


def test_weight_plane_defaults_and_particle_view():
    """w defaults to 1.0; ParticleView exposes it on both paths; an
    ElementwiseStep can read AND write it."""
    import jax.numpy as jnp

    halve = phys.ElementwiseStep(lambda p: {"w": p.w * jnp.float32(0.5)})
    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.003, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, halve)
        red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                     outputs=("W",))
        s.add_step(3, red)
        s.add_photons(light.generate_photon_state(256, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        out[fuse] = np.array(red.data, dtype=float)[:, 1]
    for rows in out.values():
        np.testing.assert_allclose(
            rows, 256 * 0.5 ** np.arange(1, rows.size + 1), rtol=1e-6)


def test_implicit_capture_exact_deterministic_attenuation():
    """Uniform absorber: total weight is N*(1-p)^k EXACTLY (no draw is
    made), photons never die, and fused == generic to f32 roundoff."""
    out = {}
    for fuse in ("auto", "off"):
        s = _absorber(fuse, implicit_capture=True)
        red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                     outputs=("W",), measure_n=True)
        s.add_step(3, red)
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        rows = np.array(red.data, dtype=float)
        assert (rows[:, 1] == 4096).all()   # nothing is ever killed
        out[fuse] = rows[:, 2]
    for rows in out.values():
        expect = 4096 * (1.0 - 0.1) ** np.arange(1, rows.size + 1)
        # f32 per-photon multiplies compound ~1 ulp/iteration: 1e-4 is
        # pure roundoff, there is NO statistical term in this number
        np.testing.assert_allclose(rows, expect, rtol=1e-4)


def test_implicit_capture_beats_analog_at_depth():
    """tau = 9: the weighted estimate of the survival fraction is
    deterministic-exact where the analog estimate carries ~9% relative
    shot noise (the variance-reduction point of the technique)."""
    k = 90
    s = _absorber("auto", t_end=k * 1e-3, implicit_capture=True)
    red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w}, outputs=("W",))
    s.add_step(3, red)
    s.start(); s.join()
    rows = np.array(red.data, dtype=float)
    expect = (1.0 - 0.1) ** rows.shape[0]   # ~7.6e-5 per photon at k=90
    weighted = rows[-1, 1] / 4096
    assert abs(weighted / expect - 1) < 1e-3

    s = _absorber("auto", t_end=k * 1e-3)   # analog twin
    s.start(); s.join()
    analog = len(s.objects) / 4096
    expect_a = (1.0 - 0.1) ** len(s.ts)
    # deterministic bound: analog is integer-quantized at 1/4096 = 3.2x the
    # expected survival, so its relative error CANNOT resolve below ~50%
    # unless the draw lands exactly on 0 or 1 survivors by luck
    assert abs(weighted - expect) < abs(analog - expect_a) or analog == 0


def test_roulette_unbiased_and_bounded():
    """Roulette keeps E[total weight] = N*(1-p)^k while killing most of the
    low-weight population and never leaves an alive weight below w_min*(1-p)."""
    k = 90
    w_min, w_sur = 1e-3, 2e-3
    s = _absorber("auto", n_phot=65536, t_end=k * 1e-3 + 1e-6, seed=3,
                  implicit_capture=True, roulette=(w_min, w_sur))
    red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w}, outputs=("W",),
                                 measure_n=True)
    s.add_step(3, red)
    s.start(); s.join()
    rows = np.array(red.data, dtype=float)
    expect = 65536 * (1.0 - 0.1) ** rows.shape[0]
    # unbiased: Sigma w within statistical tolerance of the exact value
    # (roulette survival draws are the only noise source)
    assert abs(rows[-1, 2] / expect - 1) < 0.25
    # roulette actually culls: far fewer alive than the 65536 implicit
    # capture would keep
    assert rows[-1, 1] < 65536 * 0.2
    # alive weights stay bounded: w >= w_min*(1-p) or reset to w_survive
    ws = np.array([float(o.w) for o in s.objects])
    if ws.size:
        assert ws.min() >= w_min * (1 - 0.1) * 0.999


def test_weighted_spectrum_under_implicit_capture():
    """SpectrumMeasureStep(weighted=True) bins Sigma w; unweighted counts
    stay at N (nothing dies under pure implicit capture)."""
    for fuse in ("auto", "off"):
        s = _absorber(fuse, n_phot=512, t_end=0.005,
                      implicit_capture=True)
        spec_w = light.SpectrumMeasureStep(
            None, edges=np.array([0.5, 1.5, 2.5]), weighted=True)
        spec_c = light.SpectrumMeasureStep(
            None, edges=np.array([0.5, 1.5, 2.5]))
        s.add_step(3, spec_w)
        s.add_step(4, spec_c)
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        w_rows = np.array(spec_w.data, dtype=float)
        c_rows = np.array(spec_c.data, dtype=float)
        np.testing.assert_allclose(
            w_rows[:, 1],
            512 * 0.9 ** np.arange(1, w_rows.shape[0] + 1), rtol=1e-5)
        np.testing.assert_allclose(c_rows[:, 1], 512.0)
        assert (w_rows[:, 2] == 0).all() and (c_rows[:, 2] == 0).all()


def test_source_biasing_weights_accepted():
    """generate_photon_state(w=...) and PhotonObject(w=...) seed the plane."""
    s = phys.Simulation(until_t=0.002, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    red = phys.ReduceMeasureStep(None, lambda p: {"W": p.w}, outputs=("W",))
    s.add_step(2, red)
    s.add_photons(light.generate_photon_state(
        100, E=1.0, w=np.full(100, 0.25)))
    o = light.PhotonObject(
        E=np.double(1.0),
        v=np.array([float(light.c), 0, 0], dtype=np.double), w=3.0)
    s.add_obj(o)
    s.start(); s.join()
    rows = np.array(red.data, dtype=float)
    np.testing.assert_allclose(rows[:, 1], 100 * 0.25 + 3.0, rtol=1e-6)
    # readback view exposes the weight
    ws = sorted(float(x.w) for x in s.objects)[-1]
    assert ws == pytest.approx(3.0)


def test_weight_checkpoint_roundtrip(tmp_path):
    """Weights survive save/restore (and old checkpoints default to 1.0)."""
    from physicl_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    s = _absorber("auto", n_phot=256, t_end=0.003, implicit_capture=True)
    s.start(); s.join()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(s, path)
    state, meta = load_checkpoint(path)
    w = np.asarray(state.w)[np.asarray(state.alive)]
    np.testing.assert_allclose(w, 0.9 ** len(s.ts), rtol=1e-5)
    # back-compat: a checkpoint without w loads with unit weights
    import numpy as _np
    with _np.load(path, allow_pickle=False) as z:
        stripped = {k: z[k] for k in z.files if k != "w"}
    _np.savez_compressed(str(tmp_path / "old.npz"), **stripped)
    state2, _ = load_checkpoint(str(tmp_path / "old.npz"))
    assert (np.asarray(state2.w) == 1.0).all()


def test_roulette_validation():
    with pytest.raises(ValueError, match="implicit_capture"):
        light.ScatterDeleteStep(1.0, 1.0, roulette=(1e-3, 2e-3))
    with pytest.raises(ValueError, match="0 < w_min"):
        light.ScatterDeleteStep(1.0, 1.0, implicit_capture=True,
                                roulette=(2e-3, 1e-3))
    with pytest.raises(ValueError, match="0 < w_min"):
        light.ScatterDeleteStep(1.0, 1.0, implicit_capture=True,
                                roulette=(0.0, 1e-3))


def test_emitter_resets_weight_on_recycled_slots():
    """Photons emitted into recycled (previously dead, possibly compacted)
    slots must spawn at w=1.0 on BOTH paths, even when the initial
    population was source-biased or weight-decayed (regression: the generic
    emitter forgot the reset the fused kernel does)."""
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.006, seed=5, fuse=fuse, capacity=640)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        c = float(light.c)
        # kill ~90% of the seeded photons per iteration -> slots recycle
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(2.3 / (c * 1e-3))))
        s.add_step(3, light.PhotonEmitterStep(
            100, E=np.double(7.0), v=np.array([c, 0.0, 0.0])))
        s.add_photons(light.generate_photon_state(
            500, E=1.0, w=np.full(500, 0.25)))
        s.start(); s.join()
        ws = np.array([float(o.w) for o in s.objects])
        Es = np.array([float(o.E.value()) for o in s.objects])
        emitted = np.abs(Es - 7.0) < 1e-3
        assert emitted.any(), "emitter produced no survivors"
        np.testing.assert_allclose(ws[emitted], 1.0)
        if (~emitted).any():   # seeded survivors keep their biased weight
            np.testing.assert_allclose(ws[~emitted], 0.25)


def test_weighted_plane_crossing_and_sign_tallies():
    """ScatterMeasureStep(weighted=True) reports the surface current
    (Sigma w over crossers) and weighted energy flux; SignMeasure(weighted)
    reports Sigma w per positive-velocity axis. Deterministic under pure
    implicit capture, exact on both paths."""
    c = float(light.c)
    L = 3.5 * c * 1e-3   # beam crosses the plane between iterations 3 and 4
    out = {}
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.008, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(0.2 / (c * 1e-3)),
            implicit_capture=True))
        cross = light.ScatterMeasureStep(
            None, True, [[L, np.nan, np.nan]], measure_E=True,
            measure_E_mode="sum", weighted=True)
        s.add_step(3, cross)
        sign = light.ScatterSignMeasureStep(None, measure_n=False,
                                            weighted=True)
        s.add_step(4, sign)
        s.add_photons(light.generate_photon_state(1000, E=2.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        out[fuse] = (np.array(cross.data, dtype=float),
                     np.array(sign.data, dtype=float))
    for rows, signs in out.values():
        k = rows.shape[0]
        # crossing fires exactly once (iteration 4: lo=3c*dt <= L <= 4c*dt)
        counts, fluxes = rows[:, 2], rows[:, 3]
        hits = counts > 0
        assert hits.sum() == 1 and int(np.argmax(hits)) == 3
        expect_w = 1000 * 0.8 ** 4    # weight after 4 capture decays
        np.testing.assert_allclose(counts[3], expect_w, rtol=1e-4)
        np.testing.assert_allclose(fluxes[3], expect_w * 2.0, rtol=1e-4)
        # +x beam: sign x channel is the running total weight, y/z zero
        expect_run = 1000 * 0.8 ** np.arange(1, k + 1)
        np.testing.assert_allclose(signs[:, 1], expect_run, rtol=1e-4)
        assert (signs[:, 2:] == 0).all()
    np.testing.assert_allclose(out["auto"][0], out["off"][0], rtol=1e-5)


def test_energy_deposition_conservation():
    """measure_deposition: per-iteration deposited energy satisfies exact
    conservation  initial = cumsum(deposited) + in-flight sum(w*E)  on both
    paths — deterministic under implicit capture, per-realization exact
    under analog transport."""
    import jax

    for implicit in (True, False):
        out = {}
        for fuse in ("auto", "off"):
            s = phys.Simulation(until_t=0.01, seed=2, fuse=fuse)
            s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
            s.add_step(1, phys.newton.NewtonianKinematicsStep())
            c = float(light.c)
            dele = light.ScatterDeleteStep(
                np.double(1.0), np.double(0.15 / (c * 1e-3)),
                implicit_capture=implicit, measure_deposition=True)
            s.add_step(2, dele)
            red = phys.ReduceMeasureStep(
                None, lambda p: {"WE": p.w * p.E}, outputs=("WE",))
            s.add_step(3, red)
            Es = np.linspace(1.0, 3.0, 2048)
            s.add_photons(light.generate_photon_state(2048, E=Es))
            s.start(); s.join()
            assert s.used_fused == (fuse == "auto")
            dep = np.array(dele.data, dtype=float)
            inflight = np.array(red.data, dtype=float)[:, 1]
            assert dep.shape[1] == 2
            total = np.cumsum(dep[:, 1]) + inflight
            np.testing.assert_allclose(total, Es.sum(), rtol=2e-4)
            out[fuse] = dep[:, 1]
        if implicit:  # draw-free: identical across paths to roundoff
            np.testing.assert_allclose(out["auto"], out["off"], rtol=1e-4)
            # exact expected dose: dep_k = sum_E E * p * (1-p)^(k-1)
            k = np.arange(1, out["auto"].size + 1)
            expect = Es.sum() * 0.15 * 0.85 ** (k - 1)
            np.testing.assert_allclose(out["auto"], expect, rtol=1e-3)


def test_deposition_csv(tmp_path):
    out = tmp_path / "dose.csv"
    s = phys.Simulation(until_t=0.003, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(0.5 / (float(light.c) * 1e-3)),
        implicit_capture=True, measure_deposition=True, out_fn=str(out)))
    s.add_photons(light.generate_photon_state(64, E=2.0))
    s.start(); s.join()
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 3
    first = [float(v) for v in lines[0].split(",")]
    np.testing.assert_allclose(first[1], 64 * 2.0 * 0.5, rtol=1e-4)


# ---------------------------------------------------------------------------
# Exponential transform (ScatterDeleteStep(stretch=b)): path-length
# stretching — the MCNP EXT analog in discrete-step form.
# ---------------------------------------------------------------------------


def _stretch_sim(n, seed, b, k=30, p=0.12, fuse=None, deposition=False):
    cap = ((max(16384, n) + 16383) // 16384) * 16384
    s = phys.Simulation(until_t=1e-3 * k * 0.9999, seed=seed, capacity=cap,
                        **({} if fuse is None else {"fuse": fuse}))
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    A = np.double(p / (float(light.c) * 1e-3))
    kw = {"stretch": b} if b else {}
    if deposition:
        kw["measure_deposition"] = True
    dele = light.ScatterDeleteStep(np.double(1.0), A, **kw)
    s.add_step(2, dele)
    s.add_photons(light.generate_photon_state(n, E=1.0))
    s.start(); s.join()
    st = s.sim_state
    w = np.asarray(st.w, np.float64)
    alive = np.asarray(st.alive)
    return s, float(w[alive].sum()), int(alive.sum()), dele


def test_stretch_unbiased_and_penetrates_deeper():
    """Beam along +x with mu = 1: survival prob per step drops from p to
    p*(1-b), weights carry (1-p)/(1-p(1-b)); E[sum w] stays N*(1-p)^k
    while the surviving POPULATION is N*(1-p(1-b))^k >> analog."""
    n, k, p, b = 200_000, 30, 0.12, 0.8
    s, wsum, n_alive, _ = _stretch_sim(n, seed=5, b=b, k=k, p=p)
    assert s.used_fused  # default auto-fuse: the emulated-kernel path
    expect_w = n * (1 - p) ** k
    expect_n = n * (1 - p * (1 - b)) ** k
    assert abs(wsum - expect_w) / expect_w < 0.02
    assert abs(n_alive - expect_n) / expect_n < 0.02
    assert n_alive > 5 * n * (1 - p) ** k  # genuinely deeper penetration
    # per-photon weight is DETERMINISTIC for mu=1: ((1-p)/(1-p'))^k
    st = s.sim_state
    w = np.asarray(st.w)[np.asarray(st.alive)]
    w_exact = ((1 - p) / (1 - p * (1 - b))) ** k
    np.testing.assert_allclose(w, w_exact, rtol=1e-4)


def test_stretch_fuses():
    s, wsum, n_alive, _ = _stretch_sim(100_000, seed=3, b=0.5, fuse="auto")
    assert s.used_fused, s.explain_plan()
    expect_w = 100_000 * (1 - 0.12) ** 30
    assert abs(wsum - expect_w) / expect_w < 0.03


def test_stretch_fused_matches_generic_statistically():
    n, k, p, b = 150_000, 25, 0.1, 0.6
    _, w_f, n_f, _ = _stretch_sim(n, seed=11, b=b, k=k, p=p, fuse="auto")
    s_g, w_g, n_g, _ = _stretch_sim(n, seed=11, b=b, k=k, p=p, fuse="off")
    assert not s_g.used_fused
    assert abs(w_f - w_g) / w_g < 0.03
    assert abs(n_f - n_g) / n_g < 0.02


def test_stretch_deposition_energy_balance():
    """Expected deposition stays exact: killed photons dump w*E*(p/p'),
    so E[deposited + in-flight] = N; per-realization it is statistical."""
    n, k, p, b = 200_000, 30, 0.12, 0.7
    s, wsum, _, dele = _stretch_sim(n, seed=9, b=b, k=k, p=p,
                                    deposition=True)
    dep = np.array(dele.data, dtype=float)[:, 1].sum()
    assert abs((dep + wsum) - n) / n < 0.02


def test_stretch_validation():
    with pytest.raises(ValueError, match="implicit_capture"):
        light.ScatterDeleteStep(1.0, 1e-3, implicit_capture=True,
                                stretch=0.5)
    with pytest.raises(ValueError, match="stretch"):
        light.ScatterDeleteStep(1.0, 1e-3, stretch=1.5)
    with pytest.raises(ValueError, match="stretch_dir"):
        light.ScatterDeleteStep(1.0, 1e-3, stretch=0.5,
                                stretch_dir=(0.0, 0.0, 0.0))


def test_stretch_saturated_kill_stays_unbiased():
    """Review fix: when the biased kill saturates (p*(1+b) >= 1 for
    backward movers), the cap keeps a survivor branch so the surviving
    weight is not silently lost — energy balance holds: E[deposited +
    in-flight weight] == N (it was biased low by ~(1-p) per saturated
    kill before)."""
    n, k, p, b = 100_000, 12, 0.6, 0.8
    c = float(light.c)
    cap = ((2 * n + 16383) // 16384) * 16384
    s = phys.Simulation(until_t=1e-3 * k * 0.9999, seed=13, capacity=cap)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    dele = light.ScatterDeleteStep(np.double(1.0),
                                   np.double(p / (c * 1e-3)),
                                   stretch=b, measure_deposition=True)
    s.add_step(2, dele)
    s.add_photons(light.generate_photon_state(n, E=1.0))             # mu=+1
    s.add_photons(light.generate_photon_state(n, E=1.0,
                                              v=(-c, 0.0, 0.0)))     # mu=-1
    s.start(); s.join()
    assert s.used_fused
    st = s.sim_state
    w = np.asarray(st.w, np.float64)
    alive = np.asarray(st.alive)
    dep = np.array(dele.data, dtype=float)[:, 1].sum()
    total = dep + w[alive].sum()
    # uncapped: every backward kill loses w*(1-p) = 0.4w -> total ~12%
    # low; capped: unbiased (2% statistical tolerance at 2e5 photons)
    assert abs(total - 2 * n) / (2 * n) < 0.02, total
