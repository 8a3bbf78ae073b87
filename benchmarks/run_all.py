"""Full benchmark suite: one JSON line per BASELINE.json config.

Run on the GPU: ``python benchmarks/run_all.py [--photons N] [--builder
xla]``. ``--photons`` replaces the default 10^7 population (row names
keep their ``_1e7`` suffix; each row records the population it ran);
``--builder xla`` runs every steady fused row on the XLA chunk instead of
the planner's choice (the wall-clock rows keep the planner's choice). Each
row records the builder that ran it. The
headline benchmark remains ``bench.py`` at the repo root; this suite covers
every workload family the baseline names:

1. Newtonian kinematics Euler step (runtime1.py shape)
2. Planck-distribution photon generation (+ spectra parity)
3. Spherical (isotropic) scattering transport
4. Wavelength-dependent + variable-n scattering + ScatterDeleteStep with
   mask-compaction (auto-shrink)
5. Full pipeline: generate -> propagate -> scatter -> measure;
   plus the per-photon path-trace variant at reduced N (host-bound by design:
   it streams every position to the host, like the reference's trace demos).
"""

import argparse
import json
import os as _os
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np


def steady_rate(sim_builder, n_photons, reps=6, chunk=256,
                roofline=None, sort_spec=None, builder=None):
    """Sustained photon-steps/s via the engine's own chunk provider.

    ``builder`` ("xla" / "triton", default ``--builder``) replaces the
    planner's chunk builder on the provider's plan before its first chunk.

    ``chunk=None`` lets the provider size the chunk itself (stream-plane
    workloads like tracing cap it by the record-buffer budget).
    ``sort_spec``: a voxel-table spec — apply the engine's
    ``spatial_sort=1`` policy (ops/compaction.make_spatial_sort) at
    every chunk boundary, exactly as ``Simulation(spatial_sort=1)``
    schedules it in ``_drive_fused``.
    """
    import dataclasses

    import jax
    from physicl_tpu.ops.pipeline import try_build_fused
    from physicl_tpu.state import SimState

    sim = sim_builder()
    sim.chunk_steps = chunk
    state = SimState.from_population(sim._pending_objects, sim._pending_bulk)
    steps = sim._ordered_steps()
    for s in steps:
        s.setup(sim)
    provider = try_build_fused(sim, steps, state)
    if provider is None:
        raise RuntimeError("workload did not fuse")
    builder = builder or _ARGS.builder
    if builder is not None:
        provider.plan = dataclasses.replace(provider.plan, builder=builder)
    chunk = provider.plan.chunk  # provider may have re-sized it
    sort = None
    if sort_spec is not None:
        from physicl_tpu.ops.compaction import make_spatial_sort

        sort = make_spatial_sort(sort_spec)
        state = sort(state)
    for _ in range(2):
        state, *_ = provider(state)
        if sort is not None:
            state = sort(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    # the engine's pipelined dispatch loop: two chunks in flight, harvest
    # the oldest (engine._drive_fused, fused_pipeline_depth=2)
    from collections import deque
    pending = deque()
    for _ in range(reps):
        h = provider.dispatch(state)
        state = sort(h.state) if sort is not None else h.state
        pending.append(h)
        while len(pending) > 2:
            provider.harvest(pending.popleft())
    while pending:
        provider.harvest(pending.popleft())
    jax.block_until_ready(state)
    rate = n_photons * chunk * reps / (time.perf_counter() - t0)
    _LAST["builder"] = provider.plan.builder
    if roofline is not None:
        from physicl_tpu.utils.roofline import roofline_report

        rep = roofline_report(provider.plan, state.capacity,
                              rate / n_photons * state.capacity)
        roofline.update(rep)
    return rate


def generic_steady_rate(sim_builder, n_photons, reps=4, chunk=256):
    """Sustained photon-steps/s of the GENERIC chunked scan (no fused
    kernel): the path every KernelStep, mixed-population, or prover-rejected
    pipeline runs. Tracked so fallback regressions are visible (VERDICT r2
    weak #7)."""
    import jax
    from physicl_tpu.state import SimState

    sim = sim_builder()
    sim.fuse = "off"
    sim.chunk_steps = chunk
    state = SimState.from_population(sim._pending_objects, sim._pending_bulk)
    steps = sim._ordered_steps()
    for s in steps:
        s.setup(sim)
    exit_fn, _tier = sim._exit_traced_fn(state)
    assert exit_fn is not None, "benchmark workload must have a traced exit"
    chunk_fn = sim._build_chunk_fn(steps, exit_fn, chunk, state)
    for _ in range(2):
        state, done, records, valid = chunk_fn(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, done, records, valid = chunk_fn(state)
    jax.block_until_ready(state)
    _LAST["builder"] = "generic"
    return n_photons * chunk * reps / (time.perf_counter() - t0)


def wall_rate(sim, n_photons):
    """End-to-end wall-clock rate of a threaded run (includes compile)."""
    sim.start()
    sim.join()
    return n_photons * len(sim.ts) / sim.run_time, sim


_ARGS = argparse.Namespace(builder=None, photons=10_000_000)
_LAST: dict = {}  # builder of the most recent rate, for its row


def emit(name, value, unit, baseline, roofline=None):
    import jax

    dev = jax.devices()[0]
    row = {"metric": name, "value": round(value, 1), "unit": unit,
           "vs_baseline": round(value / baseline, 1),
           "photons": _ARGS.photons, "builder": _LAST.pop("builder", None),
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    if roofline:  # hardware-utilization accounting (utils/roofline.py)
        row["vpu_util"] = roofline.get("vpu_util")
        row["hbm_util"] = roofline.get("hbm_util")
        row["flops_per_photon_step"] = roofline.get("flops_per_photon_step")
    print(json.dumps(row))


def main():
    import physicl_tpu as phys
    import physicl_tpu.newton
    import physicl_tpu.light as light

    N = _ARGS.photons

    # 1. kinematics only
    def kin():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(np.double(0.0), np.double(0.0)))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("kinematics_euler_1e7", steady_rate(kin, N), "photon-steps/s", 2.0e4)

    # 2. Planck generation
    import jax

    T, kT = 5778.0, float(light.kB.value()) * 5778.0
    # warm the CDF cache AND the jitted sampler at the benchmark shape
    jax.block_until_ready(light.planck_sample_E(
        N, 0.1 * kT, 12 * kT, T, bins=2000, device=True))

    # chained dispatches, one sync at the end: sustained device throughput
    # (keys are premade so host-side key construction stays out of the
    # window)
    reps = 16
    keys = [jax.random.PRNGKey(1 + r) for r in range(reps)]
    for timed in (False, True):  # full warmup chain first
        t0 = time.perf_counter()
        outs = [light.planck_sample_E(N, 0.1 * kT, 12 * kT, T, bins=2000,
                                      key=k, device=True) for k in keys]
        jax.block_until_ready(outs)
    gen_rate = N * reps / (time.perf_counter() - t0)
    E_dev = outs[-1]
    E = np.asarray(jax.device_get(E_dev[:1_000_000]))  # parity sample
    hist, edges = np.histogram(E, bins=40, range=(0.1 * kT, 12 * kT),
                               density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    analytic = np.array([float(light.planck_distribution(x, T).value())
                         for x in centers])
    analytic /= np.trapezoid(analytic, centers)
    mask = analytic > 0.05 * analytic.max()
    parity = float(np.abs(hist[mask] - analytic[mask]).max() / analytic[mask].max())
    assert parity < 0.05, parity
    # baseline: reference draws one sample per call with a pure-Python CDF
    # scan (~1e4 samples/s observed order)
    emit("planck_generation_1e7", gen_rate, "photons/s", 1.0e4)

    # 3. isotropic scatter transport (the headline config)
    def iso():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    rl = {}
    iso_fused = steady_rate(iso, N, roofline=rl)
    emit("isotropic_scatter_1e7", iso_fused, "photon-steps/s", 2.0e4,
         roofline=rl)

    # 3b. the SAME workload on the generic chunked scan + the fused/generic
    # ratio (every prover-rejected pipeline pays this rate)
    iso_generic = generic_steady_rate(iso, N)
    emit("isotropic_scatter_generic_1e7", iso_generic, "photon-steps/s",
         2.0e4)
    emit("fused_over_generic_ratio_isotropic", iso_fused / iso_generic,
         "x", 1.0)

    # 3c. a KernelStep workload (custom traced physics: exponential drag).
    # elementwise=True is the user contract that traces the SimState map
    # into the fused kernel (r4); the unflagged variant is the generic-scan
    # rate every opted-out custom step pays
    def kstep(elementwise=False):
        from physicl_tpu.kernels import KernelStep

        def drag(state, ctx):
            return state.replace(v=state.v * (1.0 - 1e-7))

        def build():
            s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
            s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
            s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
            s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                     n=np.double(0.001)))
            s.add_step(3, KernelStep(drag, elementwise=elementwise))
            s.add_photons(light.generate_photon_state(N, E=1.0))
            return s

        return build

    emit("kernelstep_drag_fused_1e7",
         steady_rate(kstep(elementwise=True), N), "photon-steps/s", 2.0e4)
    emit("kernelstep_drag_generic_1e7",
         generic_steady_rate(kstep(False), N), "photon-steps/s", 2.0e4)

    # 3e. voxel-media transport (3-D gridded n(r), 16^3 = 4096 entries):
    # fused via a direct gather from the flat table vs the generic scan.
    # Baseline: the reference's variable-n(r) + trace scenario (~5.5e3).
    def voxel():
        c_dt = float(light.c) * 1e-3
        vrng = np.random.default_rng(0)
        grid = vrng.uniform(0.5, 2.0, (16, 16, 16)).astype(np.float32)
        nfn = light.voxel_density(grid, origin=(-8 * c_dt,) * 3,
                                  spacing=c_dt)
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(1e-9), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    rl = {}
    vox_fused = steady_rate(voxel, N, roofline=rl)
    emit("voxel_media_1e7", vox_fused, "photon-steps/s", 5.5e3, roofline=rl)
    vox_generic = generic_steady_rate(voxel, N)
    emit("voxel_media_generic_1e7", vox_generic, "photon-steps/s", 5.5e3)
    emit("fused_over_generic_ratio_voxel", vox_fused / vox_generic, "x",
         1.0)

    # 3e'. CT-scale voxel transport (r5): 64^3 = 262,144 voxels, 200
    # materials -> packed uint8 codebook (514 table rows, dynamic
    # row-range walk). Two geometries: a radiography BEAM entering a
    # face (per-tile flat-index locality — the workload the 64^3 bar is
    # about) and uniform-random in-volume positions (the locality-free
    # worst case; the dynamic walk degrades to ~the full range).
    def voxel_ct(beam):
        c_dt = float(light.c) * 1e-3
        vrng = np.random.default_rng(0)
        vals = np.sort(vrng.uniform(0.5, 2.0, 200)).astype(np.float32)
        grid = vals[vrng.integers(0, 200, (64, 64, 64))]
        # 32 flight steps per voxel: the measured ~2048-iteration window
        # keeps the population INSIDE the grid (no border-clip shortcuts)
        sp = 32 * c_dt
        nfn = light.voxel_density(grid, origin=(0.0, 0.0, 0.0), spacing=sp)
        assert nfn.vox_spec["kind"] == "codebook"
        if beam:
            r0 = np.zeros((3, N), np.float32)
            r0[1] = vrng.uniform(0, 63 * sp, N)
            r0[2] = vrng.uniform(0, 63 * sp, N)
            v0 = None                      # collimated +x at c
        else:
            r0 = vrng.uniform(0, 63 * sp, (3, N)).astype(np.float32)
            u = vrng.normal(size=(3, N))
            u /= np.linalg.norm(u, axis=0, keepdims=True)
            v0 = (u * float(light.c)).astype(np.float32)  # isotropic
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(1e-9), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0, r=r0, v=v0))
        return s

    rl_ct = {}
    ct_beam = steady_rate(lambda: voxel_ct(True), N, roofline=rl_ct)
    emit("voxel_ct64_beam_1e7", ct_beam, "photon-steps/s", 5.5e3,
         roofline=rl_ct)
    ct_rand = steady_rate(lambda: voxel_ct(False), N)
    emit("voxel_ct64_random_1e7", ct_rand, "photon-steps/s", 5.5e3)

    # the locality-free case WITH the engine's spatial_sort=1 policy
    # (ops/compaction.make_spatial_sort): reorder by flat voxel index at
    # every chunk boundary, restoring per-tile row-range locality — the
    # r5 fix for the worst case above (2.28e8 -> ~1.1e9 measured)
    def ct64_sort_spec():
        vrng = np.random.default_rng(0)
        vals = np.sort(vrng.uniform(0.5, 2.0, 200)).astype(np.float32)
        grid = vals[vrng.integers(0, 200, (64, 64, 64))]
        sp = 32 * float(light.c) * 1e-3
        return light.voxel_density(grid, origin=(0.0, 0.0, 0.0),
                                   spacing=sp).vox_spec

    emit("voxel_ct64_random_sorted_1e7",
         steady_rate(lambda: voxel_ct(False), N,
                     sort_spec=ct64_sort_spec()),
         "photon-steps/s", 5.5e3)
    ct_generic = generic_steady_rate(lambda: voxel_ct(False), N)
    emit("voxel_ct64_generic_1e7", ct_generic, "photon-steps/s", 5.5e3)

    # 3e''. trilinear CT at the lifted 64^3 cap (r5): 8 per-corner
    # dynamic range-walks over the packed code table + 8 static
    # codebook dequants per eval — locality keeps the walked ranges
    # tiny for beam geometries
    def voxel_ct_tri(beam, side):
        c_dt = float(light.c) * 1e-3
        vrng = np.random.default_rng(0)
        vals = np.sort(vrng.uniform(0.5, 2.0, 200)).astype(np.float32)
        grid = vals[vrng.integers(0, 200, (side, side, side))]
        sp = (2048 // side) * c_dt
        nfn = light.voxel_density(grid, origin=(0.0, 0.0, 0.0), spacing=sp,
                                  interp="trilinear")
        assert nfn.vox_spec["kind"] == "codebook"
        if beam:
            r0 = np.zeros((3, N), np.float32)
            r0[1] = vrng.uniform(0, (side - 1) * sp, N)
            r0[2] = vrng.uniform(0, (side - 1) * sp, N)
            v0 = None
        else:
            r0 = vrng.uniform(0, (side - 1) * sp, (3, N)) \
                .astype(np.float32)
            u = vrng.normal(size=(3, N))
            u /= np.linalg.norm(u, axis=0, keepdims=True)
            v0 = (u * float(light.c)).astype(np.float32)
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(1e-9), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0, r=r0, v=v0))
        return s

    emit("voxel_ct32_tri_beam_1e7",
         steady_rate(lambda: voxel_ct_tri(True, 32), N),
         "photon-steps/s", 5.5e3)
    emit("voxel_ct32_tri_random_1e7",
         steady_rate(lambda: voxel_ct_tri(False, 32), N),
         "photon-steps/s", 5.5e3)
    emit("voxel_ct64_tri_beam_1e7",
         steady_rate(lambda: voxel_ct_tri(True, 64), N),
         "photon-steps/s", 5.5e3)

    def ct_tri_sort_spec(side):
        vrng = np.random.default_rng(0)
        vals = np.sort(vrng.uniform(0.5, 2.0, 200)).astype(np.float32)
        grid = vals[vrng.integers(0, 200, (side, side, side))]
        sp = (2048 // side) * float(light.c) * 1e-3
        return light.voxel_density(grid, origin=(0.0, 0.0, 0.0),
                                   spacing=sp, interp="trilinear").vox_spec

    emit("voxel_ct32_tri_random_sorted_1e7",
         steady_rate(lambda: voxel_ct_tri(False, 32), N,
                     sort_spec=ct_tri_sort_spec(32)),
         "photon-steps/s", 5.5e3)
    # UNSORTED voxel_ct64_tri_random is not benchable: the locality-free
    # worst case walks 8 x 512 rows per eval (~3e7 photon-steps/s order;
    # a steady_rate window would take ~10 min) — for that population use
    # spatial_sort=1 (row below) or fuse="off" (generic 9.2e7). NOT
    # silent truncation: documented in docs/performance.md "voxel media".
    emit("voxel_ct64_tri_random_sorted_1e7",
         steady_rate(lambda: voxel_ct_tri(False, 64), N,
                     sort_spec=ct_tri_sort_spec(64)),
         "photon-steps/s", 5.5e3)

    # 3d. polarized Rayleigh transport (full Stokes vectors: fused op
    # "pol" with a 21-plane packed state — the heaviest fused op after
    # thermal Compton: 26-step azimuth bisection + frame/Mueller algebra,
    # unroll 1) plus the generic-scan rate for the ratio
    def polarized():
        import physicl_tpu.polarization as pol

        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, pol.ScatterPolarizedRayleighStep(A=np.double(0.001),
                                                       n=np.double(0.001)))
        s.add_photons(pol.polarized_photon_state(N, E=1.0, device=True))
        return s

    rl = {}
    pol_fused = steady_rate(polarized, N, roofline=rl)
    emit("polarized_rayleigh_1e7", pol_fused, "photon-steps/s", 2.0e4,
         roofline=rl)
    pol_generic = generic_steady_rate(polarized, N)
    emit("polarized_rayleigh_generic_1e7", pol_generic,
         "photon-steps/s", 2.0e4)
    emit("fused_over_generic_ratio_polarized", pol_fused / pol_generic,
         "x", 1.0)

    # 4. lambda^-4 + variable-n + delete (with auto-shrink compaction)
    def wl():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        hc = float(light.h) * float(light.c)
        A = 0.05 / (float(light.c) * 1e-3 * (hc / 1.0) ** -4)
        s.add_step(2, light.ScatterIsotropicStep(
            A=A, n=1.0, wavelength_dep_scattering=True,
            variable_n=True, variable_n_fn="1.0 * exp(-r0[gid] / 1e9)"))
        s.add_step(3, light.ScatterDeleteStep(np.double(1e-5), np.double(1e-5)))
        s.add_step(4, light.ScatterMeasureStep(None, True,
                                               [[1e7, np.nan, np.nan]]))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("wavelength_variable_n_delete_1e7", steady_rate(wl, N),
         "photon-steps/s", 5.5e3)

    # 4b. Compton (Klein-Nishina + recoil, kn_cross_section on) — the
    # heaviest scatter op in the family (12-try Kahn rejection loop,
    # ~38 uniforms/photon/iter + the sigma_KN polynomial); tracked so the
    # gamma-transport rate is a first-class number
    def compton():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterComptonStep(
            A=0.001 / (float(light.c) * 1e-3), n=1.0, mec2=1.0,
            kn_cross_section=True))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("compton_kn_1e7", steady_rate(compton, N), "photon-steps/s", 2.0e4)

    # 4c. thermal Comptonization (Maxwell electron draw + 2 Lorentz boosts
    # on top of the Kahn loop; fused unroll forced to 1)
    def comptonization():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterComptonStep(
            A=0.001 / (float(light.c) * 1e-3), n=1.0, mec2=1e9,
            theta_e=0.01))
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("comptonization_thermal_1e7", steady_rate(comptonization, N),
         "photon-steps/s", 2.0e4)

    # 4d. on-device spectra: two 56-bin SpectrumMeasureSteps (counts +
    # energy sums, 116 float record channels — near the 128-wide record-row
    # ceiling) tallied in-kernel every iteration at 1e7 photons
    def spectrum():
        edges = np.exp(np.linspace(-3.0, 4.0, 57))
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterComptonStep(
            A=0.001 / (float(light.c) * 1e-3), n=1.0, mec2=1e9,
            theta_e=0.01))
        s.add_step(3, light.SpectrumMeasureStep(
            None, edges=edges, measure_n=True, underflow=True,
            overflow=True))
        s.add_step(4, light.SpectrumMeasureStep(
            None, edges=edges, weight="energy", underflow=True,
            overflow=True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("spectrum_56bin_x2_thermal_1e7", steady_rate(spectrum, N),
         "photon-steps/s", 2.0e4)

    # 4e. weighted transport: implicit capture + roulette + weighted
    # transmission tally (the non-analog deep-penetration workload)
    def weighted():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(0.05 / (float(light.c) * 1e-3)),
            implicit_capture=True, roulette=(1e-4, 2e-4)))
        s.add_step(3, phys.ReduceMeasureStep(
            None, lambda p: {"W": p.w}, outputs=("W",), measure_n=True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("implicit_capture_roulette_1e7", steady_rate(weighted, N),
         "photon-steps/s", 1.4e5)

    # 4e'. exponential transform: analog kill biased by the direction
    # cosine, survivors carry the likelihood ratio (round-3 cont.: the
    # MCNP EXT analog) — two extra flops + one dot product per photon-step
    def stretched():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(0.001 / (float(light.c) * 1e-3)),
            stretch=0.7))
        s.add_step(3, light.ScatterSignMeasureStep(None, True,
                                                   weighted=True))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("exponential_transform_1e7", steady_rate(stretched, N),
         "photon-steps/s", 1.4e5)

    # 4f. charged-particle dynamics: the Boris pusher (half-E kick, exact B
    # rotation, half-E kick) fused over an all-generic population — the
    # PIC-style workload (no reference counterpart; vs_baseline uses the
    # reference's observed transport rate)
    def lorentz():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.LorentzForceStep(
            E_field=(4.0, 0.0, 0.0), B_field=(0.0, 0.0, 200.0),
            q_over_m=1.0))
        s.add_step(2, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(3, light.ScatterSignMeasureStep(None, True))
        s.add_particles(physicl_tpu.newton.generate_particle_state(
            N, v=(1.0, 0.0, 0.0)))
        return s

    emit("lorentz_boris_exb_1e7", steady_rate(lorentz, N),
         "particle-steps/s", 2.0e4)

    # 4g. mixed-species transport: 5e6 photons (isotropic scatter +
    # absorption, otype-gated) + 5e6 charged particles (Boris push) in one
    # kernel — tracks the per-particle type-dispatch overhead vs the pure
    # photon path
    def mixed():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.LorentzForceStep(
            B_field=(0.0, 0.0, 200.0), q_over_m=1.0))
        s.add_step(2, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(3, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
        s.add_step(4, light.ScatterDeleteStep(np.double(1e-9),
                                              np.double(1e-9)))
        s.add_step(5, light.ScatterSignMeasureStep(None, True))
        s.add_photons(light.generate_photon_state(N // 2, E=1.0))
        s.add_particles(physicl_tpu.newton.generate_particle_state(
            N // 2, v=(1.0, 0.0, 0.0)))
        return s

    emit("mixed_species_1e7", steady_rate(mixed, N), "particle-steps/s",
         2.0e4)

    # 5a. full pipeline end-to-end (generate -> propagate -> scatter ->
    # measure), wall clock including compile and Planck generation
    t0 = time.perf_counter()
    E = light.planck_sample_E(N, 0.1 * kT, 12 * kT, T, bins=2000, seed=2)
    s = phys.Simulation(exit=lambda c: c.t >= 0.256, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                             n=np.double(0.001)))
    s.add_step(3, light.ScatterMeasureStep(None, True,
                                           [[1e7, np.nan, np.nan]]))
    s.add_photons(light.generate_photon_state(N, E=E))
    rate, s = wall_rate(s, N)
    emit("full_pipeline_wall_1e7_incl_compile", rate, "photon-steps/s", 1.4e4)

    # 5b. per-photon path trace — round 2: device-resident (the fused kernel
    # DMAs positions to an HBM stream buffer; nothing crosses to the host
    # during the run). Steady-state chunk rate, like the other workloads.
    Nt = 100_000

    def trace():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
        s.add_step(3, light.TracePathMeasureStep(None))
        s.add_photons(light.generate_photon_state(Nt, E=1.0))
        return s

    emit("path_trace_steady_1e5", steady_rate(trace, Nt, chunk=None),
         "photon-steps/s", 1.4e4)

    # ...unstrided tracing at full 1e7 scale with bf16 stream planes:
    # half the stream bytes => twice the iterations per dispatch (the
    # every-iteration reference demo shape; documented ~0.4% position
    # precision waiver, docs/api.md)
    def trace_bf16():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
        s.add_step(3, light.TracePathMeasureStep(None,
                                                 trace_dtype="bfloat16"))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("path_trace_bf16_unstrided_steady_1e7",
         steady_rate(trace_bf16, N, chunk=None, reps=4),
         "photon-steps/s", 1.4e4)

    # ...and strided tracing (trace_every=16) at full 1e7 scale: the kernel
    # skips the stream DMA off sample iterations, so 16x more iterations fit
    # one dispatch (output = exactly every 16th row of the unstrided trace)
    def trace_strided():
        s = phys.Simulation(exit=lambda c: c.t >= 1e9, seed=0)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                 n=np.double(0.001)))
        s.add_step(3, light.TracePathMeasureStep(None, trace_every=16))
        s.add_photons(light.generate_photon_state(N, E=1.0))
        return s

    emit("path_trace_strided16_steady_1e7",
         steady_rate(trace_strided, N, chunk=None, reps=4),
         "photon-steps/s", 1.4e4)

    # ...and end-to-end wall clock including compile and final host assembly
    # of the reference-format trace matrix arrays
    t0 = time.perf_counter()
    s = phys.Simulation(exit=lambda c: c.t >= 0.250, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                             n=np.double(0.001)))
    tr = light.TracePathMeasureStep(None, trace_dv=True)
    s.add_step(3, tr)
    s.add_photons(light.generate_photon_state(Nt, E=1.0))
    rate, s = wall_rate(s, Nt)
    emit("path_trace_wall_1e5_incl_compile", rate, "photon-steps/s", 1.4e4)


if __name__ == "__main__":
    _ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _ap.add_argument("--photons", type=int, default=10_000_000)
    _ap.add_argument("--builder", choices=("xla",), default=None)
    _ARGS = _ap.parse_args()
    main()
