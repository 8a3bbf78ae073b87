"""Spatial population sort (``Simulation(spatial_sort=K)``).

Periodically reordering the population by flat voxel index makes each
kernel block gather from a narrow band of the voxel table — the classic
particle sort of event-based Monte Carlo transport, keyed to our x-major
table layout. These tests pin the slot contract (a pure reorder that
preserves ``n_spawned`` and the free tail), physics neutrality, exact
fused-vs-generic parity when both paths sort, and the structured
refusals. The reference has no counterpart (its population is a Python
list, physicl/__init__.py:443-459).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton


def _grid16():
    ii = (np.arange(16, dtype=np.float32) % 8)
    return np.broadcast_to((1.0 + ii / 8.0)[:, None, None],
                           (16, 16, 16)).copy()


def test_make_spatial_sort_slot_contract():
    """Alive particles sort by flat voxel index; spawned-but-dead slots
    pack after them; the never-spawned free tail stays a tail;
    ``n_spawned`` and every scalar are untouched; all planes move under
    ONE permutation (a photon keeps its own r/v/E/w)."""
    from physicl_tpu.ops.compaction import make_spatial_sort
    from physicl_tpu.state import SimState

    cap, n_sp = 512, 300
    rng = np.random.default_rng(0)
    st = SimState.zeros(cap)
    r = rng.uniform(0.0, 16.0, (3, cap)).astype(np.float32)
    alive = np.zeros(cap, bool)
    alive[:n_sp] = rng.uniform(size=n_sp) < 0.7
    st = st.replace(
        r=jnp.asarray(r), E=jnp.asarray(np.arange(cap, dtype=np.float32)),
        w=jnp.asarray(rng.uniform(0.1, 1.0, cap).astype(np.float32)),
        alive=jnp.asarray(alive), n_spawned=jnp.int32(n_sp))
    spec = {"shape": (16, 16, 16), "origin": (0.0, 0.0, 0.0),
            "spacing": (1.0, 1.0, 1.0)}
    out = make_spatial_sort(spec)(st)

    assert int(out.n_spawned) == n_sp
    alive_o = np.asarray(out.alive)
    n_alive = int(alive.sum())
    # region layout: [alive sorted][spawned dead][free tail]
    assert alive_o[:n_alive].all() and not alive_o[n_alive:].any()
    # alive block ordered by flat index
    ro = np.asarray(out.r)
    flat = ((np.clip(np.round(ro[0]), 0, 15).astype(int) * 16
             + np.clip(np.round(ro[1]), 0, 15).astype(int)) * 16
            + np.clip(np.round(ro[2]), 0, 15).astype(int))
    assert (np.diff(flat[:n_alive]) >= 0).all()
    # one permutation carried every plane: E was the identity tag, so
    # each photon's (r, w) must still match its original slot's values
    Eo = np.asarray(out.E).astype(int)
    np.testing.assert_array_equal(ro, r[:, Eo])
    np.testing.assert_array_equal(np.asarray(out.w),
                                  np.asarray(st.w)[Eo])
    # the moved multiset is exactly the original slots (no dup/loss)
    assert sorted(Eo.tolist()) == list(range(cap))
    # free tail slots kept their relative order at the very back
    assert (np.diff(Eo[n_sp:]) > 0).all()


def _run(fuse, sort, *, seed=3, n=512, chunk=4, trace=False,
         mesh=None, capacity=None):
    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    nfn = light.voxel_density(_grid16(), origin=(0, 0, 0), spacing=c_dt)
    s = phys.Simulation(until_t=0.010 * 0.9999, seed=seed, fuse=fuse,
                        spatial_sort=sort, chunk_steps=chunk, mesh=mesh,
                        capacity=capacity)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(A), variable_n=True,
        variable_n_fn=nfn, implicit_capture=True))
    if trace:
        s.add_step(3, light.TracePathMeasureStep(None))
    # distinct positions across the grid: per-photon weights then differ
    # (density gradient along x), so a reorder is visible in slot order
    rng = np.random.default_rng(7)
    r0 = rng.uniform(0, 15 * c_dt, (3, n)).astype(np.float32)
    s.add_photons(light.generate_photon_state(n, E=1.0, r=r0))
    s.start(); s.join()
    return s


def test_spatial_sort_physics_neutral_and_parity():
    """Sorting is a pure reorder: the per-photon weight MULTISET matches
    the unsorted run (implicit capture is draw-free here), and the fused
    and generic paths — both sorting at the same chunk boundaries —
    agree exactly, slot for slot."""
    w0 = np.asarray(_run("auto", 0).sim_state.w, np.float64)
    s1 = _run("auto", 1)
    assert s1.used_fused
    w1 = np.asarray(s1.sim_state.w, np.float64)
    w2 = np.asarray(_run("off", 1).sim_state.w, np.float64)
    np.testing.assert_array_equal(np.sort(w0), np.sort(w1))
    np.testing.assert_array_equal(w1, w2)
    assert not np.array_equal(w0, w1)  # the sort really moved slots
    # the final population is ordered by x-major flat index among alive
    st = s1.sim_state
    alive = np.asarray(st.alive)
    c_dt = float(light.c) * 0.001
    r = np.asarray(st.r)[:, alive] / c_dt
    flat = ((np.clip(np.round(r[0]), 0, 15).astype(int) * 16
             + np.clip(np.round(r[1]), 0, 15).astype(int)) * 16
            + np.clip(np.round(r[2]), 0, 15).astype(int))
    # the last sort happened <= chunk steps ago and photons fly one
    # voxel per step here, so exact monotonicity has washed out — but
    # the slot order must still track flat index strongly (unsorted
    # uniform populations correlate at ~0)
    assert np.corrcoef(flat, np.arange(flat.size))[0, 1] > 0.8


def test_spatial_sort_interval_every_k_chunks():
    """spatial_sort=K sorts on chunk 0, K, 2K, ... (tick counter), not
    every chunk."""
    s = _run("auto", 2, chunk=2)
    assert s._sort_fn is not None
    assert "spatial sort" in s.explain_plan()
    # 10 engine steps at chunk=2 => 5+ dispatches, ticks advanced, and
    # sorts happened on the even ticks only
    assert s._sort_tick >= 5
    w_sorted = np.asarray(s.sim_state.w, np.float64)
    w_plain = np.asarray(_run("auto", 0).sim_state.w, np.float64)
    np.testing.assert_array_equal(np.sort(w_plain), np.sort(w_sorted))


def test_spatial_sort_refusals():
    """Structured refusals: no voxel medium => [no-voxel-table]; path
    tracing => [stable-ids]; both leave the run correct and unsorted."""
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        s = phys.Simulation(until_t=0.002 * 0.9999, seed=0, spatial_sort=1)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(np.double(0.0),
                                              np.double(0.0)))
        s.add_photons(light.generate_photon_state(64, E=1.0))
        s.start(); s.join()
    assert any("no-voxel-table" in str(x.message) for x in wl)
    assert s._sort_fn is None

    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        s = _run("auto", 1, trace=True)
    assert any("stable-ids" in str(x.message) for x in wl)
    assert s._sort_fn is None


def test_spatial_sort_blocks_midrun_removal():
    """Requesting spatial_sort makes slots unstable: mid-run remove_obj
    must refuse (same contract as recycling/auto-shrink)."""
    s = phys.Simulation(until_t=0.010, seed=0, spatial_sort=1)
    o = light.PhotonObject(v=np.array([light.c.value(), 0, 0]), E=1.0)
    s.add_obj(o)
    assert not s._slots_stable
    s.running = True
    try:
        with pytest.raises(RuntimeError, match="stable slots"):
            s.remove_obj(o)
    finally:
        s.running = False


def test_spatial_sort_on_mesh_matches_single_device():
    """The mesh path (out_shardings pinned to the particle sharding,
    global argsort over shards) reorders to the identical state as the
    single-device sort."""
    from physicl_tpu.parallel import make_mesh
    from physicl_tpu.ops.compaction import make_spatial_sort
    from physicl_tpu.parallel.sharding import shard_state
    from physicl_tpu.state import SimState

    cap = 1024
    rng = np.random.default_rng(1)
    st = SimState.zeros(cap)
    st = st.replace(
        r=jnp.asarray(rng.uniform(0, 16, (3, cap)).astype(np.float32)),
        E=jnp.asarray(np.arange(cap, dtype=np.float32)),
        alive=jnp.asarray(rng.uniform(size=cap) < 0.8),
        n_spawned=jnp.int32(cap))
    spec = {"shape": (16, 16, 16), "origin": (0.0, 0.0, 0.0),
            "spacing": (1.0, 1.0, 1.0)}
    plain = make_spatial_sort(spec)(st)
    mesh = make_mesh()
    st_sh = shard_state(st, mesh)
    sorted_sh = make_spatial_sort(spec, mesh)(st_sh)
    for name in ("r", "E", "alive", "w"):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(getattr(sorted_sh, name))),
            np.asarray(jax.device_get(getattr(plain, name))), err_msg=name)
