"""The two fused chunk builders: the Triton kernel (in interpret mode here)
against the XLA chunk on every op family, the shared random stream, the
planner's static choice, and the compile-cache location.

The kernel runs through the Pallas interpreter, called directly rather than
through ``Simulation``'s thread. Its lowering for CUDA is checked too: that
step runs on the CPU, so an op the Triton route cannot lower fails here.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.light as light
import physicl_tpu.newton as newton
from physicl_tpu.ops import families as FA
from physicl_tpu.ops import fused as F

# 2 programs x 256 photons x 8 iterations
_CAP, _ROWS, _ITERS = 512, 2, 8


def _both(kind, seed=7):
    plan = FA.family_plan(kind, chunk=_ITERS, tile_rows=_ROWS)
    args = FA.family_inputs(plan, _CAP) + (seed, _ITERS)
    ref = F._build_xla_chunk(plan, _CAP)(*args)
    got = F._build_triton_chunk(plan, _CAP, interpret=True)(*args)
    return plan, args, ref, got


@pytest.mark.parametrize("kind", FA.FAMILIES)
def test_kernel_matches_xla_chunk(kind):
    """Identical draws, identical op bodies: state planes, integer tallies
    and stream planes are bitwise equal; float tallies differ only by the
    order in which blocks add."""
    plan, args, ref, got = _both(kind)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref[2]),
                               rtol=1e-5, atol=1e-5)
    if plan.n_stream:
        np.testing.assert_array_equal(
            np.asarray(got[3], np.float32), np.asarray(ref[3], np.float32))
    assert FA.compare_chunks(plan, ref, got)["ok"]
    # the chunk did something: some plane moved
    assert not np.array_equal(np.asarray(ref[0]), args[0])


@pytest.mark.parametrize("kind", [k for k in FA.FAMILIES if k != "kstate"])
def test_kernel_lowers_for_cuda(kind):
    """The Triton route lowers every family the planner sends to it (the
    lowering to Triton IR runs on the host; compiling it needs the card)."""
    plan = FA.family_plan(kind, chunk=_ITERS, tile_rows=_ROWS)
    args = FA.family_inputs(plan, _CAP) + (7, _ITERS)
    lowered = jax.jit(F._build_triton_chunk(plan, _CAP)).trace(
        *args).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()
    assert F.kernel_lowers(plan) is None


def test_tiles_draw_the_global_stream():
    """A tile starting at global row r0 draws exactly the rows [r0, r0+t)
    of the whole-population stream, for every draw method."""
    seed, k = jnp.int32(11), jnp.int32(5)
    whole = F._Rng(seed, k)
    full = [whole.bits((8, 128)), whole.uniform((8, 128)),
            *whole.uniform_pair((8, 128)), whole.bits((8, 128), salt=3)]
    for r0 in (0, 2, 4, 6):
        tile = F._Rng(seed, k, row0=jnp.int32(r0))
        part = [tile.bits((2, 128)), tile.uniform((2, 128)),
                *tile.uniform_pair((2, 128)), tile.bits((2, 128), salt=3)]
        for a, b in zip(full, part):
            np.testing.assert_array_equal(np.asarray(a)[r0:r0 + 2],
                                          np.asarray(b))
    # the stream depends on the seed and the iteration
    other = F._Rng(jnp.int32(12), k).bits((8, 128))
    assert not np.array_equal(np.asarray(full[0]), np.asarray(other))


def test_split_into_tiles_changes_nothing():
    """The same chunk at 1, 2 or 4 rows per program gives the same state:
    the hash is keyed on global coordinates, not on the tiling."""
    outs = []
    for rows in (1, 2, 4):
        plan = FA.family_plan("hg", chunk=_ITERS, tile_rows=rows)
        args = FA.family_inputs(plan, _CAP) + (3, _ITERS)
        outs.append(np.asarray(
            F._build_triton_chunk(plan, _CAP, interpret=True)(*args)[0]))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def _headline(**kw):
    s = phys.Simulation(until_t=0.0035, seed=1, **kw)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                             n=np.double(0.001)))
    s.add_step(3, light.ScatterSignMeasureStep(None, True))
    s.add_photons(light.generate_photon_state(1000, E=1.0))
    return s


def test_planner_uses_xla_chunk_on_cpu():
    s = _headline()
    text = s.explain_plan()
    assert "fused chunk builder: xla" in text
    assert "cpu backend" in text
    s.start(); s.join()
    assert s.used_fused and len(s.ts) == 4


def test_planner_picks_kernel_on_gpu_never_interpret(monkeypatch):
    """With the backend reported as a GPU the planner picks the Triton
    kernel, and the builder compiles it for the card: no interpret mode."""
    plan = FA.family_plan("iso", chunk=_ITERS)
    monkeypatch.setattr(F.jax, "default_backend", lambda: "gpu")
    builder, why = F.choose_builder(plan)
    assert builder == "triton" and "Triton" in why
    seen = {}

    def fake(plan, capacity, interpret=False):
        seen["interpret"] = interpret
        return "runner"

    monkeypatch.setattr(F, "_build_triton_chunk", fake)
    assert F._build_fused_chunk_uncached(
        dataclasses.replace(plan, builder=builder), _CAP) == "runner"
    assert seen == {"interpret": False}
    monkeypatch.undo()
    monkeypatch.setattr(F.jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="CPU test tool"):
        F._build_triton_chunk(plan, _CAP, interpret=True)


def test_planner_routes_unlowerable_plans_to_xla(monkeypatch):
    """Plans the kernel cannot lower go to the XLA chunk at plan time, with
    the lowering's own reason; nothing is compiled to find out."""
    monkeypatch.setattr(F.jax, "default_backend", lambda: "gpu")
    plan = FA.family_plan("kstate", chunk=_ITERS)
    builder, why = F.choose_builder(plan)
    assert builder == "xla" and "concatenate" in why
    # a user callable with a primitive the Triton route has no rule for
    rounded = dataclasses.replace(FA.family_plan("iso", chunk=_ITERS), ops=[
        F._Op("kin"),
        F._Op("custom", custom_fn=lambda v: {"E": jnp.round(v.E * 4.0)})])
    builder, why = F.choose_builder(rounded)
    assert builder == "xla" and "round" in why
    # a primitive that has a rule but whose lowering fails on its operands
    negated = dataclasses.replace(rounded, ops=[
        F._Op("kin"),
        F._Op("custom", custom_fn=lambda v: {"E": v.E * -jnp.float32(1.0)})])
    assert F.kernel_lowers(negated) is not None
    assert F.choose_builder(negated)[0] == "xla"


def test_planner_keeps_wide_tallies_on_xla(monkeypatch):
    """Plans tallying more record columns than pay on the kernel go to the
    XLA chunk even though the kernel lowers them."""
    monkeypatch.setattr(F.jax, "default_backend", lambda: "gpu")
    wide = FA.family_plan("spectrum_wide", chunk=_ITERS)
    assert F.kernel_lowers(wide) is None
    assert F._record_columns(wide) > F.KERNEL_MAX_REC_COLS
    builder, why = F.choose_builder(wide)
    assert builder == "xla" and "record columns" in why
    narrow = FA.family_plan("reduce", chunk=_ITERS)
    assert F._record_columns(narrow) == 4
    assert F.choose_builder(narrow)[0] == "triton"


def test_planner_choice_is_shown_and_cached(monkeypatch):
    """explain_plan() names the builder and its reason; the plan-time check
    runs once per plan structure."""
    monkeypatch.setattr(F.jax, "default_backend", lambda: "gpu")
    plan = FA.family_plan("kstate", chunk=_ITERS)
    F._blocker_cache.clear()
    calls = []
    real = F.kernel_lowers
    monkeypatch.setattr(F, "kernel_lowers",
                        lambda p: calls.append(p) or real(p))
    first = F.choose_builder(plan)
    assert F.choose_builder(plan) == first and len(calls) == 1
    monkeypatch.undo()
    text = _headline().explain_plan()
    assert "fused chunk builder: xla" in text


def test_compare_chunks_flags_divergence():
    plan, args, ref, got = _both("iso")
    assert FA.compare_chunks(plan, ref, ref)["ok"]
    bad = np.asarray(got[0]).copy()
    bad[F._RX, :3] += 1e3 * np.maximum(1.0, np.abs(bad[F._RX, :3]))
    res = FA.compare_chunks(plan, ref, (bad,) + tuple(got[1:]))
    assert res["branched"] == 3 and not res["ok"]
    rec = np.asarray(got[1]).copy()
    rec[0, 0] += 1
    assert not FA.compare_chunks(plan, ref, (got[0], rec, got[2]))["ok"]


def test_compile_cache_honors_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and no other cache is set; without it
    the cache goes to the fixed in-checkout default."""
    from physicl_tpu.utils import cache

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        got = cache.enable_persistent_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache") == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    monkeypatch.setenv("PHYSICL_NO_COMPILE_CACHE", "1")
    assert cache.enable_persistent_compilation_cache() is None


def test_compile_cache_off_on_cpu(monkeypatch):
    from physicl_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_persistent_compilation_cache() is None
