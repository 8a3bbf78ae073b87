"""Fluorescent re-emission (``ScatterDeleteStep(fluorescence=(Y, E_f))``,
extension — the reference's absorption can only delete,
physicl/light.py:146-158).

Key invariants, enforced on BOTH execution paths:

* two-state decay: a monoenergetic beam above the edge leaves the source
  line at rate ``p`` per iteration and populates the fluorescence line at
  ``E[B(k)] = N*Y*p*k*(1-p)^(k-1)`` (equal hit rates above/below the edge
  when ``A_fn`` is absent);
* per-realization energy conservation: ``N*E0 == sum(deposited) +
  sum(alive E)`` EXACTLY (not just in expectation) — every kill deposits
  ``w*E``, every re-emission ``w*(E - E_f)``;
* re-emission is TRUE-isotropic (cos-theta uniform — physical emission,
  not the scatter family's reference-parity angle-uniform convention) at
  speed c;
* re-emitted photons are unpolarized: Stokes/frame extras zero, even
  when no polarized scatter op is in the pipeline (the fused plan must
  pack + write back the planes for the del op alone);
* ``Y = 1`` with source == line == edge re-emits forever: N is exactly
  conserved.
"""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light


def _sim(fuse, n_phot, p_step, k, seed=0, E0=2.0, **del_kw):
    s = phys.Simulation(until_t=k * 1e-3, seed=seed, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    c = float(light.c)
    dele = light.ScatterDeleteStep(
        np.double(1.0), np.double(p_step / (c * 1e-3)), **del_kw)
    s.add_step(2, dele)
    s.add_photons(light.generate_photon_state(n_phot, E=E0))
    return s, dele


def test_validation():
    mk = lambda **kw: light.ScatterDeleteStep(1.0, 1.0, **kw)
    with pytest.raises(ValueError, match="yield"):
        mk(fluorescence=(0.0, 1.0))
    with pytest.raises(ValueError, match="yield"):
        mk(fluorescence=(1.5, 1.0))
    with pytest.raises(ValueError, match="positive"):
        mk(fluorescence=(0.5, -1.0))
    with pytest.raises(ValueError, match="edge"):
        mk(fluorescence=(0.5, 2.0), fluorescence_edge=1.0)
    with pytest.raises(ValueError, match="implicit_capture"):
        mk(fluorescence=(0.5, 1.0), implicit_capture=True)
    with pytest.raises(ValueError, match="stretch"):
        mk(fluorescence=(0.5, 1.0), stretch=0.5)
    with pytest.raises(ValueError, match="requires fluorescence"):
        mk(fluorescence_edge=1.0)
    # valid: edge defaults to E_f
    assert mk(fluorescence=(0.5, 1.0)).fluorescence == (0.5, 1.0, 1.0)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_two_state_decay(fuse):
    """Source line drains at (1-p)^k; fluorescence line follows the
    two-state closed form N*Y*p*k*(1-p)^(k-1) (E_f below the edge, so
    line photons absorb outright at the same rate p)."""
    N, p, Y, k = 65536, 0.1, 0.6, 20
    s, _ = _sim(fuse, N, p, k, E0=2.0,
                fluorescence=(Y, 1.0), fluorescence_edge=1.5)
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)[alive]
    assert set(np.unique(E)) <= {1.0, 2.0}
    n_src = int((E == 2.0).sum())
    n_line = int((E == 1.0).sum())
    np.testing.assert_allclose(n_src, N * (1 - p) ** k, rtol=0.05)
    np.testing.assert_allclose(
        n_line, N * Y * p * k * (1 - p) ** (k - 1), rtol=0.05)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_energy_conservation_exact(fuse):
    """Per-realization identity (not expectation): initial energy equals
    deposited + in-flight, to f32 roundoff."""
    N, p, k, E0 = 16384, 0.15, 25, 2.0
    s, dele = _sim(fuse, N, p, k, E0=E0,
                   fluorescence=(0.7, 0.8), fluorescence_edge=1.2,
                   measure_deposition=True)
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    st = s.sim_state
    alive = np.asarray(st.alive)
    inflight = float(np.asarray(st.E, np.float64)[alive].sum())
    deposited = float(np.array(dele.data, dtype=float)[:, 1].sum())
    np.testing.assert_allclose(inflight + deposited, N * E0, rtol=1e-4)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_isotropic_reemission(fuse):
    """Line photons: cos-theta uniform on [-1, 1] (true isotropy) and
    |v| = c exactly."""
    N, p, Y, k = 262144, 0.1, 1.0, 8
    s, _ = _sim(fuse, N, p, k, E0=2.0,
                fluorescence=(Y, 1.0), fluorescence_edge=1.5, seed=3)
    s.start(); s.join()
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)
    line = alive & (E == 1.0)
    v = np.asarray(st.v, np.float64)[:, line]
    n_line = v.shape[1]
    assert n_line > 20000
    c = float(light.c)
    speed = np.sqrt((v ** 2).sum(axis=0))
    np.testing.assert_allclose(speed, c, rtol=1e-5)
    cos_t = v[2] / speed
    # uniform cos: mean 0 (sd = 1/sqrt(3 n)), P(|cos| < 0.5) = 0.5
    assert abs(cos_t.mean()) < 4.0 / np.sqrt(3 * n_line) + 0.005
    np.testing.assert_allclose((np.abs(cos_t) < 0.5).mean(), 0.5,
                               atol=0.02)
    # azimuth uniform: <cos phi>, <sin phi> ~ 0
    phi = np.arctan2(v[1], v[0])
    assert abs(np.cos(phi).mean()) < 0.02
    assert abs(np.sin(phi).mean()) < 0.02


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_reemitted_photons_unpolarized(fuse):
    """A fully Q-polarized beam: re-emitted line photons carry zero
    Stokes/frame extras; untouched source photons keep theirs — on the
    fused path WITHOUT any polarized scatter op in the pipeline (the del
    op alone must pack + write back the planes)."""
    from physicl_tpu.polarization import polarized_photon_state

    N, p, k = 16384, 0.2, 10
    s = phys.Simulation(until_t=k * 1e-3, seed=1, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    c = float(light.c)
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(p / (c * 1e-3)),
        fluorescence=(0.8, 1.0), fluorescence_edge=1.5))
    s.add_photons(polarized_photon_state(N, E=2.0, stokes=(1.0, 0.0, 0.0)))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)
    stokes = np.asarray(st.extras["stokes"], np.float64)
    pol_ref = np.asarray(st.extras["pol_ref"], np.float64)
    line = alive & (E == 1.0)
    src = alive & (E == 2.0)
    assert line.sum() > 100 and src.sum() > 100
    assert np.abs(stokes[:, line]).max() == 0.0
    assert np.abs(pol_ref[:, line]).max() == 0.0
    np.testing.assert_allclose(stokes[0, src], 1.0, atol=1e-6)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("plane", ["stokes", "pol_ref"])
def test_reemitted_zeroing_half_declared_population(fuse, plane):
    """A population declaring only ONE of stokes/pol_ref (legal: the
    generic apply zeroes each plane independently, light.py) must still
    get that plane packed + written back on the fused path — the old
    both-planes gate left stale host polarization on re-emitted lanes
    (ADVICE r3, pipeline.py per-plane packing)."""
    N, p, k = 16384, 0.2, 10
    s = phys.Simulation(until_t=k * 1e-3, seed=1, fuse=fuse)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    c = float(light.c)
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(p / (c * 1e-3)),
        fluorescence=(0.8, 1.0), fluorescence_edge=1.5))
    vals = np.tile(np.array([[1.0], [0.5], [0.25]]), (1, N))
    s.add_photons(light.generate_photon_state(N, E=2.0,
                                              extras={plane: vals}))
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)
    arr = np.asarray(st.extras[plane], np.float64)
    line = alive & (E == 1.0)
    src = alive & (E == 2.0)
    assert line.sum() > 100 and src.sum() > 100
    assert np.abs(arr[:, line]).max() == 0.0
    np.testing.assert_allclose(arr[0, src], 1.0, atol=1e-6)


def test_sharded_mesh_energy_budget_and_two_state():
    """8-device mesh: the per-realization energy identity holds globally
    (deposition is psum-reduced across shards) and the two-state decay
    matches the closed forms."""
    from physicl_tpu.parallel import make_mesh

    N, p, Y, k, E0 = 65536, 0.1, 0.6, 20, 2.0
    s = phys.Simulation(until_t=k * 1e-3, seed=2, fuse="auto",
                        mesh=make_mesh())
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    dele = light.ScatterDeleteStep(
        np.double(1.0), np.double(p / (float(light.c) * 1e-3)),
        fluorescence=(Y, 1.0), fluorescence_edge=1.5,
        measure_deposition=True)
    s.add_step(2, dele)
    s.add_photons(light.generate_photon_state(N, E=E0))
    s.start(); s.join()
    assert s.used_fused
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)
    inflight = float(E[alive].sum())
    deposited = float(np.array(dele.data, dtype=float)[:, 1].sum())
    np.testing.assert_allclose(inflight + deposited, N * E0, rtol=1e-4)
    n_src = int((alive & (E == E0)).sum())
    n_line = int((alive & (E == 1.0)).sum())
    np.testing.assert_allclose(n_src, N * (1 - p) ** k, rtol=0.05)
    np.testing.assert_allclose(
        n_line, N * Y * p * k * (1 - p) ** (k - 1), rtol=0.05)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_unit_yield_at_line_conserves_n(fuse):
    """Y=1 with source == line == edge: every absorption re-emits (the
    inclusive edge test), so N is EXACTLY conserved while directions
    randomize."""
    N, p, k = 8192, 0.3, 15
    s, _ = _sim(fuse, N, p, k, E0=1.0, fluorescence=(1.0, 1.0), seed=7)
    red = phys.ReduceMeasureStep(None, lambda q: {"W": q.w},
                                 outputs=("W",), measure_n=True)
    s.add_step(3, red)
    s.start(); s.join()
    assert s.used_fused == (fuse == "auto")
    st = s.sim_state
    assert int(np.asarray(st.alive).sum()) == N
    rows = np.array(red.data, dtype=float)
    assert (rows[:, 1] == N).all()
    # directions have randomized off the +x beam
    assert (np.abs(np.asarray(st.v, np.float64)[2]) > 0).any()
