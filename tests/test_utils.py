"""Checkpoint/resume, native CSV writer, profiling step."""

import os

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light
from physicl_tpu.utils import io as pio


def _sim(t_end, seed=0, restore=None):
    s = phys.Simulation(exit=lambda c: c.t >= t_end, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    if restore is None:
        s.add_photons(light.generate_photon_state(500, E=1.0))
    else:
        s.restore_checkpoint(restore)
    return s


def test_checkpoint_resume_equals_straight_run(tmp_path):
    ckpt = str(tmp_path / "ck.npz")

    # straight run to t=0.010
    a = _sim(0.010)
    a.start(); a.join()
    ra = np.asarray(a.sim_state.r)

    # run to 0.005, checkpoint, resume to 0.010
    b1 = _sim(0.005)
    b1.start(); b1.join()
    b1.save_checkpoint(ckpt)
    b2 = _sim(0.010, restore=ckpt)
    b2.start(); b2.join()
    rb = np.asarray(b2.sim_state.r)

    assert np.allclose(ra, rb, rtol=1e-6)
    assert len(b2.ts) == len(a.ts) == 10
    assert np.allclose(b2.ts, a.ts)


def test_checkpoint_roundtrip_fields(tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    s = _sim(0.003)
    s.start(); s.join()
    s.save_checkpoint(ckpt)
    from physicl_tpu.utils.checkpoint import load_checkpoint

    state, meta = load_checkpoint(ckpt)
    assert state.capacity == s.sim_state.capacity
    assert meta["initial_count"] == 500
    assert np.isclose(float(state.t), 0.003, rtol=1e-5)


def test_native_csv_writer(tmp_path):
    p = str(tmp_path / "m.csv")
    m = np.array([[1.0, 2.5, np.nan], [3.0, -4.25e-12, 299792458.0]])
    pio.write_matrix(p, m)
    lines = open(p).read().strip().split("\n")
    assert len(lines) == 2
    row0 = lines[0].split(", ")
    assert float(row0[0]) == 1.0 and float(row0[1]) == 2.5
    assert row0[2] == "nan"
    row1 = lines[1].split(", ")
    assert float(row1[1]) == -4.25e-12
    assert float(row1[2]) == 299792458.0


def test_native_csv_builds():
    # the fast path should actually build on this image (g++ available)
    assert pio.native_available()


def test_write_rows_ragged_fallback(tmp_path):
    p = str(tmp_path / "r.csv")
    pio.write_rows(p, [[1, "a"], [2]])
    assert open(p).read() == "1, a\n2\n"


def test_write_rows_durable_dir_target_writes_partial(tmp_path, monkeypatch):
    """Unwritable target (a directory) -> data lands in <path>.partial with
    a warning, not an exception (reference intent: physicl/__init__.py:367-378
    retried forever interactively; we retry bounded then fall back)."""
    monkeypatch.setattr(pio.time, "sleep", lambda s: None)
    target = str(tmp_path / "outdir")
    os.mkdir(target)
    with pytest.warns(RuntimeWarning, match="partial"):
        dest = pio.write_rows(target, [[1, "a"], [2]])
    assert dest == target + ".partial"
    assert open(dest).read() == "1, a\n2\n"


def test_write_matrix_durable_missing_dir_falls_to_tmpdir(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(pio.time, "sleep", lambda s: None)
    target = str(tmp_path / "no" / "such" / "dir" / "m.csv")
    with pytest.warns(RuntimeWarning, match="data saved to"):
        dest = pio.write_matrix(target, np.array([[1.0, 2.0]]))
    assert os.path.exists(dest) and dest.endswith("m.csv")
    assert [float(x) for x in open(dest).read().strip().split(", ")] == [1, 2]
    os.remove(dest)


def test_write_rows_transient_eacces_retries_then_succeeds(tmp_path,
                                                           monkeypatch):
    sleeps = []
    monkeypatch.setattr(pio.time, "sleep", sleeps.append)
    p = str(tmp_path / "ok.csv")
    calls = {"n": 0}
    real_open = open

    def flaky_open(path, mode="r", *a, **k):
        if path == p and mode == "w":
            calls["n"] += 1
            if calls["n"] <= 2:
                raise PermissionError(13, "simulated EACCES")
        return real_open(path, mode, *a, **k)

    monkeypatch.setattr("builtins.open", flaky_open)
    dest = pio.write_rows(p, [[1, "a"]])  # ragged -> python writer
    assert dest == p
    assert calls["n"] == 3 and len(sleeps) == 2  # backoff between attempts
    assert real_open(p).read() == "1, a\n"


def test_measure_step_dict_data_writes_key_value_rows(tmp_path):
    """Dict-shaped MeasureStep data keeps its keys in the CSV (the
    reference's dict branch intended k,v rows, physicl/__init__.py:374)."""
    p = str(tmp_path / "d.csv")
    m = phys.MeasureStep(out_fn=p)
    m.data = {"a": [1, 2], "b": 3}
    m.terminate(None)
    assert open(p).read() == "a, 1, 2\nb, 3\n"


def test_chunk_timer_step():
    from physicl_tpu.utils.profiling import ChunkTimerStep

    s = _sim(0.005)
    timer = ChunkTimerStep()
    s.add_step(9, timer)
    s.start(); s.join()
    assert len(timer.data) >= 1
    iters = sum(row[0] for row in timer.data)
    assert iters == 5


def test_compact_and_shrink():
    import jax.numpy as jnp
    from physicl_tpu.ops.compaction import compact, compact_shrink
    from physicl_tpu.state import SimState

    state = SimState.from_population(
        [], [light.generate_photon_state(16384 * 2, E=1.0)])
    # kill all but 100 photons with a recognizable pattern
    alive = np.zeros(state.capacity, bool)
    keep = np.arange(0, 10000, 100)
    alive[keep] = True
    E = np.arange(state.capacity, dtype=np.float32)
    state = state.replace(alive=jnp.asarray(alive), E=jnp.asarray(E))

    packed = compact(state)
    assert int(packed.alive[:100].sum()) == 100
    assert int(packed.alive[100:].sum()) == 0
    # stable order: E values of survivors preserved in original order
    assert np.array_equal(np.asarray(packed.E[:100]), E[keep])

    small = compact_shrink(state, 100)
    assert small.capacity == 16384
    assert int(small.n_alive) == 100
    assert np.array_equal(np.asarray(small.E[:100]), E[keep])


def test_auto_shrink_extinction_run():
    # strong absorption: population collapses fast; engine should shrink
    s = phys.Simulation(seed=0)
    s.exit = lambda x: len(x.objects) == 0
    s.chunk_steps = 4  # several chunks so shrink can trigger mid-run
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(np.double(0.001), np.double(0.001)))
    meas = light.ScatterMeasureStep(None, True, [[1e5, np.nan, np.nan]])
    s.add_step(3, meas)
    s.add_photons(light.generate_photon_state(16384 * 8, E=1.0))
    s.start(); s.join()
    assert len(s.objects) == 0
    assert s.sim_state.capacity < 16384 * 8  # it shrank
    # decay statistics unaffected: pcoll = 0.2998 per step
    ns = np.array([row[1] for row in meas.data[:6]], float)
    assert np.allclose(ns[1:] / ns[:-1], 0.7002, atol=0.02)


def test_auto_shrink_disabled_by_trace_step():
    s = phys.Simulation(seed=0, exit=lambda c: c.t >= 0.02, chunk_steps=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(np.double(0.002), np.double(0.002)))
    s.add_step(3, light.TracePathMeasureStep(None))
    for _ in range(64):
        s.add_obj(light.PhotonObject(
            E=np.double(1.0),
            v=np.array([float(light.c), 0, 0], dtype=np.double)))
    s.start(); s.join()
    assert s.sim_state.capacity == 16384  # never shrank below initial pad
    assert len(s.steps[3].data) == 65  # header + all 64 rows intact


def test_checkpoint_typed_key_roundtrip(tmp_path):
    """prng_impl="rbg" (an opt-in generator for the generic path)
    produces typed key arrays; checkpoints serialize them as raw key
    data + impl name and restore an identical key."""
    import jax
    from physicl_tpu.utils.checkpoint import load_checkpoint

    s = _sim(0.003)
    s.prng_impl = "rbg"
    s.start(); s.join()
    ck = str(tmp_path / "rbg.npz")
    s.save_checkpoint(ck)
    state, meta = load_checkpoint(ck)
    assert meta["key_impl"] == "rbg"
    assert jax.dtypes.issubdtype(state.key.dtype, jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(state.key)),
        np.asarray(jax.random.key_data(s.sim_state.key)))
    # and the restore actually resumes
    s2 = _sim(0.006, restore=ck)
    s2.start(); s2.join()
    assert len(s2.ts) == 6
