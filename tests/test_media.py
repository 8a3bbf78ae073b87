"""Gridded-media density fields: layered_density (gather-free, fused) and
voxel_density (3-D grids, generic path with a structured refusal)."""

import numpy as np
import pytest

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

jnp = pytest.importorskip("jax.numpy")


def test_layered_density_values():
    fn = light.layered_density([0.0, 1.0, 3.0], [2.0, 5.0], axis="y",
                               outside=0.25)
    y = jnp.asarray([-0.5, 0.0, 0.5, 1.0, 2.9, 3.0, 10.0])
    z = jnp.zeros_like(y)
    out = np.asarray(fn(z, y, z))
    np.testing.assert_allclose(out, [0.25, 2.0, 2.0, 5.0, 5.0, 0.25, 0.25])

    rfn = light.layered_density([1.0, 2.0], [7.0], axis="r",
                                center=(1.0, 0.0, 0.0))
    x = jnp.asarray([1.0, 2.5, 4.0])   # radii 0, 1.5, 3
    out = np.asarray(rfn(x, jnp.zeros_like(x), jnp.zeros_like(x)))
    np.testing.assert_allclose(out, [0.0, 7.0, 0.0])

    with pytest.raises(ValueError, match="increasing"):
        light.layered_density([1.0, 1.0], [2.0])
    with pytest.raises(ValueError, match="len\\(values\\)"):
        light.layered_density([0.0, 1.0], [1.0, 2.0])
    with pytest.raises(ValueError, match="axis"):
        light.layered_density([0.0, 1.0], [1.0], axis="q")


def test_layered_density_fused_exact_attenuation():
    """Implicit-capture transport through a two-layer slab stays FUSED and
    reproduces the exact per-layer weight decay w = prod(1 - A*n(x_k)*c*dt)
    on both execution paths."""
    c_dt = float(light.c) * 0.001
    A = 0.3 / c_dt
    # layers aligned to flight steps: iterations 1-3 inside n=1 (x = 1..3
    # c_dt), iterations 4-6 inside n=2, beyond = vacuum
    nfn = light.layered_density(
        np.array([0.5, 3.5, 6.5]) * c_dt, [1.0, 2.0])
    expect = (1 - 0.3) ** 3 * (1 - 0.6) ** 3
    for fuse in ("auto", "off"):
        s = phys.Simulation(until_t=0.008 * 0.9999, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(256, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        w = np.asarray(s.sim_state.w, np.float64)
        alive = np.asarray(s.sim_state.alive)
        np.testing.assert_allclose(w[alive], expect, rtol=1e-5)


def test_voxel_density_nearest_and_trilinear():
    grid = jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4)
    fn = light.voxel_density(grid, origin=(10.0, 0.0, 0.0),
                             spacing=(1.0, 2.0, 0.5), outside=-1.0)
    x = jnp.asarray([10.0, 11.0, 10.4, 9.0])
    y = jnp.asarray([0.0, 4.0, 1.1, 0.0])
    z = jnp.asarray([0.0, 1.5, 0.2, 0.0])
    out = np.asarray(fn(x, y, z))
    # [0,0,0]=0; [1,2,3]=23; nearest of (0.4, 0.55, 0.4) -> [0,1,0]=4;
    # x=9 is outside
    np.testing.assert_allclose(out, [0.0, 23.0, 4.0, -1.0])

    # trilinear reproduces a linear field exactly at arbitrary points
    ii, jj, kk = np.meshgrid(np.arange(5), np.arange(6), np.arange(7),
                             indexing="ij")
    lin = (2.0 * ii - 3.0 * jj + 0.5 * kk + 1.0).astype(np.float32)
    tfn = light.voxel_density(lin, origin=(0, 0, 0), spacing=1.0,
                              interp="trilinear")
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.uniform(0, 4, 64), jnp.float32)
    py = jnp.asarray(rng.uniform(0, 5, 64), jnp.float32)
    pz = jnp.asarray(rng.uniform(0, 6, 64), jnp.float32)
    got = np.asarray(tfn(px, py, pz), np.float64)
    want = (2.0 * np.asarray(px, np.float64)
            - 3.0 * np.asarray(py, np.float64)
            + 0.5 * np.asarray(pz, np.float64) + 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    with pytest.raises(ValueError, match="3-D"):
        light.voxel_density(np.zeros((2, 2)))
    with pytest.raises(ValueError, match="interp"):
        light.voxel_density(np.zeros((2, 2, 2)), interp="cubic")
    with pytest.raises(ValueError, match="positive"):
        light.voxel_density(np.zeros((2, 2, 2)), spacing=0.0)


def test_voxel_density_oversize_grid_refuses_fused_with_reason():
    """A CONTINUOUS voxel grid (> 256 distinct values, no quantize=) past
    light.MAX_FUSED_VOXELS forces the generic scan via the structured
    field-fn-gather refusal; near-constant values keep the exact
    implicit-capture decay law checkable."""
    c_dt = float(light.c) * 0.001
    A = 0.2 / c_dt
    # > 256 distinct values (no codebook tier), but constant 1.0 in the
    # region the photons can reach (they start at the origin and move
    # < one 9*c_dt voxel in 5 steps), so the decay law stays exact
    grid = np.full((32, 32, 16), 1.0, np.float32)
    grid[8:] = (1.0 + (np.arange(24 * 32 * 16) % 512 + 1)
                * np.float32(1e-5)).reshape(24, 32, 16).astype(np.float32)
    assert grid.size > light.MAX_FUSED_VOXELS
    assert np.unique(grid).size > 256
    nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=9 * c_dt)
    s = phys.Simulation(until_t=0.005 * 0.9999, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(A), variable_n=True, variable_n_fn=nfn,
        implicit_capture=True))
    s.add_photons(light.generate_photon_state(128, E=1.0))
    with pytest.warns(RuntimeWarning, match="field-fn-gather"):
        s.start(); s.join()
    assert not s.used_fused
    assert any(code == "field-fn-gather"
               for code, _ in s.plan_report.refusals)
    w = np.asarray(s.sim_state.w, np.float64)
    alive = np.asarray(s.sim_state.alive)
    np.testing.assert_allclose(w[alive], (1 - 0.2) ** 5, rtol=1e-5)


def test_voxel_density_fused_constant_grid_exact_decay():
    """A voxel medium UNDER the table budget fuses (VERDICT r3 #1: the
    reference keeps user n(r) inside its kernel, physicl/light.py:295-315
    — gridded media must not fall off to the generic scan) and
    reproduces the exact constant-density implicit-capture decay on both
    paths."""
    c_dt = float(light.c) * 0.001
    A = 0.2 / c_dt
    grid = np.full((4, 4, 4), 1.0, np.float32)
    for fuse in ("auto", "off"):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=9 * c_dt)
        assert nfn.vox_spec is not None
        s = phys.Simulation(until_t=0.005 * 0.9999, seed=0, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(128, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        w = np.asarray(s.sim_state.w, np.float64)
        alive = np.asarray(s.sim_state.alive)
        np.testing.assert_allclose(w[alive], (1 - 0.2) ** 5, rtol=1e-5)


def test_voxel_density_fused_vs_generic_gradient_parity():
    """Fused-vs-generic parity through a NON-uniform voxel medium: a
    density gradient along x makes each iteration's kill probability
    depend on the in-kernel table lookup; per-photon weights must agree
    exactly between paths (identical arithmetic, exact lookups)."""
    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    ii = np.arange(16, dtype=np.float32)
    grid = np.broadcast_to((1.0 + ii / 4.0)[:, None, None],
                           (16, 8, 8)).copy()
    ws = {}
    for fuse in ("auto", "off"):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt)
        s = phys.Simulation(until_t=0.010 * 0.9999, seed=3, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(512, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        ws[fuse] = np.asarray(s.sim_state.w, np.float64)
    np.testing.assert_array_equal(ws["auto"], ws["off"])
    # the gradient actually bit: weights vary photon-to-photon only via
    # shared trajectory here, but must differ from the uniform-density law
    assert not np.allclose(ws["auto"][:512], (1 - 0.05) ** 10)


def test_vox_kernel_field_matches_direct_lookup():
    """The in-kernel voxel field (direct gather from the flat table,
    ops/fused.py) computes EXACTLY the same values as voxel_density's XLA
    gather — both interps, positions inside, outside and on clip edges."""
    from physicl_tpu.ops import fused as F

    rng = np.random.default_rng(7)
    for interp, shape in (("nearest", (8, 16, 32)),   # 4096 = 16 segments
                          ("trilinear", (10, 9, 11))):
        grid = rng.uniform(0.5, 3.0, size=shape).astype(np.float32)
        fn = light.voxel_density(grid, origin=(-1.0, 0.5, 2.0),
                                 spacing=(0.3, 0.7, 0.11),
                                 interp=interp, outside=-2.5)
        spec = fn.vox_spec
        assert spec["kind"] == "f32"    # continuous values: no codebook
        kfn = F._bind_vox_field(spec, F._vox_table_of(spec))
        # positions spanning coverage + outside + edges, as (256, 128) tiles
        lo = np.array([-1, 0.5, 2.0]) - 2
        hi = lo + np.array(shape) * np.array([0.3, 0.7, 0.11]) + 4
        P = 256 * 128
        pts = rng.uniform(lo, hi, size=(P, 3)).astype(np.float32)
        r0, r1, r2 = (jnp.asarray(pts[:, i].reshape(256, 128))
                      for i in range(3))
        got = np.asarray(kfn(r0, r1, r2))
        want = np.asarray(fn(r0, r1, r2))
        np.testing.assert_array_equal(got, want, err_msg=interp)


def test_voxel_density_fused_on_sharded_mesh():
    """Voxel tables are closure constants of the per-shard kernel: the
    8-device mesh run must reproduce the unsharded per-photon weights
    exactly (same grid, same deterministic implicit-capture decay)."""
    from physicl_tpu.parallel import make_mesh

    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    ii = np.arange(16, dtype=np.float32)
    grid = np.broadcast_to((1.0 + ii / 4.0)[:, None, None],
                           (16, 8, 8)).copy()
    ws = {}
    for mesh in (None, make_mesh()):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt)
        s = phys.Simulation(until_t=0.010 * 0.9999, seed=3, mesh=mesh,
                            capacity=16384 * (8 if mesh else 1))
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(512, E=1.0))
        s.start(); s.join()
        assert s.used_fused
        import jax
        ws["mesh" if mesh else "single"] = np.asarray(
            jax.device_get(s.sim_state.w), np.float64)[:512]
    np.testing.assert_array_equal(ws["mesh"], ws["single"])
    assert not np.allclose(ws["mesh"], 1.0)  # the medium acted


def test_voxel_codebook_tier_selection():
    """light.voxel_density picks the packed-codebook table whenever the
    grid has <= 256 distinct values and fewer walked rows result; past
    the f32 cap the codebook is the ONLY fused tier (r4 VERDICT item 1:
    real CT grids must not fall off a 74x cliff), and continuous
    oversize grids refuse unless quantize= is given."""
    # tiny constant grid: 1 f32 row beats 1 code row + 1 codebook row
    fn = light.voxel_density(np.full((4, 4, 4), 2.0, np.float32))
    assert fn.vox_spec["kind"] == "f32"
    # 16^3 with 3 distinct values: 2-bit codes, 2+1 rows vs 32 f32 rows
    g = np.zeros((16, 16, 16), np.float32)
    g[4:8] = 1.5
    g[8:] = 3.0
    fn = light.voxel_density(g)
    assert fn.vox_spec["kind"] == "codebook" and fn.vox_spec["bits"] == 2
    # 12 distinct -> 4-bit; 200 distinct -> 8-bit
    g12 = (np.arange(16 ** 3) % 12).reshape(16, 16, 16).astype(np.float32)
    assert light.voxel_density(g12).vox_spec["bits"] == 4
    g200 = (np.arange(64 ** 3) % 200).reshape(64, 64, 64) \
        .astype(np.float32)
    fn = light.voxel_density(g200)        # 64^3 = 262144 > f32 cap
    assert fn.vox_spec["kind"] == "codebook" and fn.vox_spec["bits"] == 8
    assert not getattr(fn, "pallas_incompatible", False)
    # trilinear segmented grids fuse up to the same 64^3 cap (r5: the
    # dynamic row-range walk keeps the 8 per-corner walks cheap, so the
    # old 40^3 trilinear cap was lifted)
    g40 = (np.arange(40 ** 3) % 100).reshape(40, 40, 40) \
        .astype(np.float32)
    assert light.voxel_density(g40, interp="trilinear") \
        .vox_spec["kind"] == "codebook"
    f64t = light.voxel_density(g200, interp="trilinear")
    assert f64t.vox_spec["kind"] == "codebook"
    assert not getattr(f64t, "pallas_incompatible", False)
    # continuous 64^3: refuses without quantize=, fuses with it
    rng = np.random.default_rng(0)
    gc = rng.uniform(0.5, 2.0, (64, 64, 64)).astype(np.float32)
    assert getattr(light.voxel_density(gc), "pallas_incompatible", False)
    fq = light.voxel_density(gc, quantize=256)
    assert fq.vox_spec["kind"] == "codebook"
    assert 0.0 < fq.quantize_err < (2.0 - 0.5) / 128  # ~bin half-width


def test_vox_codebook_kernel_field_matches_direct_lookup():
    """Codebook-tier grids (the tier light.voxel_density picks for <= 256
    distinct values) read through the in-kernel field give EXACTLY the
    generic callable's values — all three code widths, both interps."""
    import jax
    from physicl_tpu.ops import fused as F

    rng = np.random.default_rng(11)
    cases = (
        ("nearest", (40, 40, 40), 200),    # 8-bit, 126 code rows
        ("nearest", (16, 16, 16), 12),     # 4-bit
        ("nearest", (16, 8, 8), 3),        # 2-bit
        ("trilinear", (18, 12, 10), 100),  # 8-bit, 8-corner dequant
        ("trilinear", (12, 10, 8), 9),     # 4-bit
        ("trilinear", (16, 10, 8), 3),     # 2-bit
    )
    for interp, shape, n_mat in cases:
        vals = np.sort(rng.uniform(0.25, 4.0, n_mat)).astype(np.float32)
        grid = vals[rng.integers(0, n_mat, shape)]
        fn = light.voxel_density(grid, origin=(-1.0, 0.5, 2.0),
                                 spacing=(0.3, 0.7, 0.11),
                                 interp=interp, outside=-2.5)
        spec = fn.vox_spec
        assert spec["kind"] == "codebook", (interp, shape, n_mat)
        # eager like fn: under jit XLA contracts the trilinear
        # multiply-adds into FMAs, a rounding difference this exactness
        # test must not absorb (both production paths run jitted)
        kfn = F._bind_vox_field(spec, F._vox_table_of(spec))
        lo = np.array([-1, 0.5, 2.0]) - 2
        hi = lo + np.array(shape) * np.array([0.3, 0.7, 0.11]) + 4
        pts = rng.uniform(lo, hi, size=(256 * 128, 3)).astype(np.float32)
        r0, r1, r2 = (jnp.asarray(pts[:, i].reshape(256, 128))
                      for i in range(3))
        got = np.asarray(kfn(r0, r1, r2))
        want = np.asarray(fn(r0, r1, r2))
        np.testing.assert_array_equal(
            got, want, err_msg=f"{interp} {shape} {n_mat}")


@pytest.mark.slow
def test_vox_codebook_kernel_field_64cube_exact():
    """Full 64^3 CT-scale codebook grid — exact vs the generic gather,
    including positions outside coverage."""
    import jax
    from physicl_tpu.ops import fused as F

    rng = np.random.default_rng(13)
    vals = np.sort(rng.uniform(0.1, 3.0, 256)).astype(np.float32)
    grid = vals[rng.integers(0, 256, (64, 64, 64))]
    fn = light.voxel_density(grid, spacing=0.5)
    spec = fn.vox_spec
    assert spec["kind"] == "codebook" and spec["bits"] == 8
    kfn = jax.jit(F._bind_vox_field(spec, F._vox_table_of(spec)))
    fn = jax.jit(fn)   # same jit context: identical FMA contraction
    pts = rng.uniform(-2.0, 34.0, size=(256 * 128, 3)).astype(np.float32)
    r0, r1, r2 = (jnp.asarray(pts[:, i].reshape(256, 128))
                  for i in range(3))
    np.testing.assert_array_equal(np.asarray(kfn(r0, r1, r2)),
                                  np.asarray(fn(r0, r1, r2)))


@pytest.mark.slow
def test_vox_trilinear_kernel_field_64cube_exact():
    """Full 64^3 TRILINEAR codebook grid — vs the generic 8-corner
    gather, including positions outside coverage."""
    import jax
    from physicl_tpu.ops import fused as F

    rng = np.random.default_rng(17)
    vals = np.sort(rng.uniform(0.1, 3.0, 256)).astype(np.float32)
    grid = vals[rng.integers(0, 256, (64, 64, 64))]
    fn = light.voxel_density(grid, spacing=0.5, interp="trilinear")
    spec = fn.vox_spec
    assert spec["kind"] == "codebook" and spec["bits"] == 8
    kfn = jax.jit(F._bind_vox_field(spec, F._vox_table_of(spec)))
    fn = jax.jit(fn)
    pts = rng.uniform(-2.0, 34.0, size=(256 * 128, 3)).astype(np.float32)
    r0, r1, r2 = (jnp.asarray(pts[:, i].reshape(256, 128))
                  for i in range(3))
    # XLA may contract the wx*wy*wz*corner chains into FMAs differently
    # across the two jit programs, so jitted-vs-jitted equality is 1 ulp,
    # not bitwise; the
    # eager kernel-field test above pins BITWISE equality, and the
    # end-to-end gradient-parity test pins exact fused-vs-generic
    # weights through the production pipelines.
    np.testing.assert_allclose(np.asarray(kfn(r0, r1, r2)),
                               np.asarray(fn(r0, r1, r2)),
                               rtol=3e-7, atol=0)


def test_voxel_trilinear_fused_vs_generic_gradient_parity():
    """End-to-end fused-vs-generic parity through a TRILINEAR segmented
    medium on the codebook tier: per-photon implicit-capture weights
    must agree exactly, and the plan must actually fuse."""
    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    ii = (np.arange(24, dtype=np.float32) % 12)
    grid = np.broadcast_to((1.0 + ii / 8.0)[:, None, None],
                           (24, 24, 24)).copy()
    ws = {}
    for fuse in ("auto", "off"):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt,
                                  interp="trilinear")
        assert nfn.vox_spec["kind"] == "codebook"
        s = phys.Simulation(until_t=0.010 * 0.9999, seed=3, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(512, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        ws[fuse] = np.asarray(s.sim_state.w, np.float64)
    np.testing.assert_array_equal(ws["auto"], ws["off"])
    assert not np.allclose(ws["auto"][:512], (1 - 0.05) ** 10)


def test_voxel_codebook_fused_vs_generic_gradient_parity():
    """End-to-end fused-vs-generic parity through a 64^3 segmented
    medium (the r4 VERDICT CT-scale bar): per-photon implicit-capture
    weights must agree exactly, and the plan must actually fuse."""
    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    ii = (np.arange(64, dtype=np.float32) % 32)
    grid = np.broadcast_to((1.0 + ii / 8.0)[:, None, None],
                           (64, 64, 64)).copy()
    assert grid.size > light.MAX_FUSED_VOXELS
    ws = {}
    for fuse in ("auto", "off"):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt)
        assert nfn.vox_spec["kind"] == "codebook"
        s = phys.Simulation(until_t=0.010 * 0.9999, seed=3, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(512, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        ws[fuse] = np.asarray(s.sim_state.w, np.float64)
    np.testing.assert_array_equal(ws["auto"], ws["off"])
    assert not np.allclose(ws["auto"][:512], (1 - 0.05) ** 10)


def test_voxel_quantize_snaps_both_paths_identically():
    """quantize=K is declared semantics: the generic path sees the SAME
    snapped grid as the fused codebook (exact parity), the snap error is
    bounded by the quantile bin width, and K levels are respected."""
    c_dt = float(light.c) * 0.001
    A = 0.05 / c_dt
    rng = np.random.default_rng(5)
    grid = rng.uniform(1.0, 2.0, (32, 32, 32)).astype(np.float32)
    ws, snapped = {}, {}
    for fuse in ("auto", "off"):
        nfn = light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt,
                                  quantize=64)
        assert nfn.vox_spec["kind"] == "codebook"
        assert len(nfn.vox_spec["codebook"]) <= 64
        assert 0.0 < nfn.quantize_err <= (2.0 - 1.0) / 64
        s = phys.Simulation(until_t=0.010 * 0.9999, seed=9, fuse=fuse)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(A), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(light.generate_photon_state(256, E=1.0))
        s.start(); s.join()
        assert s.used_fused == (fuse == "auto")
        ws[fuse] = np.asarray(s.sim_state.w, np.float64)
        snapped[fuse] = np.asarray(nfn.vox_spec["flat"]).copy()
    # the snapped grid itself is shared bitwise between paths; the decay
    # weights agree to 1 ulp/step (XLA contracts the same jnp multiply
    # chain differently in while- vs scan-loop contexts — the r4
    # mod_floor gotcha — so arbitrary-mantissa values cannot demand
    # bitwise equality across loop forms; exact-parity tests use
    # short-mantissa grids on purpose)
    np.testing.assert_array_equal(snapped["auto"], snapped["off"])
    np.testing.assert_allclose(ws["auto"], ws["off"], rtol=2e-6)
    # and the snap really changed values (it is not a no-op)
    assert not np.array_equal(snapped["auto"],
                              grid.astype(np.float32).reshape(-1))


def test_voxel_codebook_beer_lambert_line_integral():
    """Beer-Lambert through a 64^3 two-material slab phantom: the
    implicit-capture weight of a photon crossing the slab equals
    prod_k (1 - A*n_k*c*dt) over its per-step voxel densities — an
    EXACT line-integral check computed independently in NumPy."""
    c_dt = float(light.c) * 0.001
    A = 0.1 / c_dt
    grid = np.ones((64, 64, 64), np.float32)
    grid[20:40] = 2.5                      # a dense slab along x
    spacing = 2.0 * c_dt                   # photon crosses 32 voxels
    # quarter-voxel origin shift: step-end positions land at fx =
    # (k + 1.5) / 2, never on a .5 rounding tie, so f32 position
    # accumulation drift cannot flip the voxel choice vs this model
    nfn = light.voxel_density(grid, origin=(-0.5 * c_dt, 0, 0),
                              spacing=spacing)
    assert nfn.vox_spec["kind"] == "codebook" and nfn.vox_spec["bits"] == 2
    s = phys.Simulation(until_t=0.064 * 0.9999, seed=1, fuse="auto")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(A), variable_n=True, variable_n_fn=nfn,
        implicit_capture=True))
    s.add_photons(light.generate_photon_state(64, E=1.0))
    s.start(); s.join()
    assert s.used_fused
    # photons fly +x at speed c from the origin: position at the START
    # of step k is (k * c_dt, 0, 0); density sampled AFTER the kinematics
    # update at position ((k+1) * c_dt, 0, 0)
    w_expect = 1.0
    for k in range(64):
        fx = (k + 1.5) / 2.0
        ix = int(np.clip(np.round(fx), 0, 63))
        inside = -0.5 <= fx < 63.5
        n_k = float(grid[ix, 0, 0]) if inside else 0.0
        w_expect *= 1.0 - min(A * n_k * c_dt, 1.0)
    w = np.asarray(s.sim_state.w, np.float64)
    alive = np.asarray(s.sim_state.alive)
    np.testing.assert_allclose(w[alive], w_expect, rtol=5e-5)
