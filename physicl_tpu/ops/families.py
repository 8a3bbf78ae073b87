"""One fused plan per op family, for comparing the chunk builders.

Each family drives one op kind (or one variant of it) that
:func:`physicl_tpu.ops.fused._emit_iteration` handles, on a seeded
population whose scale makes every op act: positions span a few mean free
paths, directions are isotropic, and collision probabilities per step are
order 0.1. The tests run the Triton kernel (interpret mode) against the XLA
chunk on every family, and ``chip_smoke.py`` does the same on the card with
both compiled builders.
"""

from __future__ import annotations

import numpy as np

from physicl_tpu.ops import fused as F
from physicl_tpu.state import OBJ_GENERIC, OBJ_PHOTON

DT = 1e-3  # schedule step (code seconds)

_POL = ("stokes:0", "stokes:1", "stokes:2",
        "pol_ref:0", "pol_ref:1", "pol_ref:2")


def _c():
    import physicl_tpu.light as light

    return float(light.c)


def family_ops(kind: str):
    """(ops, n_rec_cols, n_stream, stream_dtype, extras, writeback,
    species) of one family. Lengths are in units of one step, L = c*dt."""
    import jax.numpy as jnp
    import physicl_tpu.light as light

    c = _c()
    L = c * DT
    p = 1.0 / L  # coefficient giving pcoll = 1 per step at |dr| = L
    kin = F._Op("kin")
    iso = F._Op("iso", coef=0.2 * p, c_val=c)
    sign = F._Op("sign", cols=(1, 2))
    photon = OBJ_PHOTON
    out = dict(n_rec=5, n_stream=0, sdtype="float32", extras=(),
               writeback=(), species=photon)

    def fam(ops, **kw):
        d = dict(out, **kw)
        return (ops, d["n_rec"], d["n_stream"], d["sdtype"], d["extras"],
                d["writeback"], d["species"])

    if kind == "iso":
        return fam([kin, iso, sign])
    if kind == "varn":
        iso_v = F._Op("iso", coef=0.2 * p, c_val=c, wl_base=1.0,
                      n_fn=lambda x, y, z: jnp.exp(-x * jnp.float32(0.1 / L)))
        return fam([kin, iso_v, F._Op("del", coef=0.05 * p),
                    F._Op("cross", cols=(1,),
                          axes=((0, 0.5 * L, 2, 0, -1),))])
    if kind == "emit":
        return fam([F._Op("emit", emit_n=64, emit_E=2.0,
                          emit_r=(0.0, 0.0, 0.0), emit_v=None, c_val=c,
                          emit_sched_idx=0),
                    kin,
                    F._Op("absorb", bounds=((-3 * L, 3 * L),) * 3),
                    F._Op("cross", cols=(1,), axes=((0, 0.5 * L, 2, 0, -1),))])
    if kind == "emit_icdf":
        kT = float(light.kB.value()) * 5778.0
        sampler = light.PlanckSampler(0.1 * kT, 12 * kT, 5778.0, bins=2000)
        return fam([F._Op("emit", emit_n=64, emit_E=0.0,
                          emit_E_fn=sampler.icdf, emit_r=(0.0, 0.0, 0.0),
                          emit_v=(c, 0.0, 0.0), c_val=c, emit_sched_idx=0),
                    kin, F._Op("del", coef=0.05 * p)], n_rec=3)
    if kind == "hg":
        return fam([kin, F._Op("hg", coef=0.2 * p, c_val=c, g=0.73), sign])
    if kind == "rayl":
        return fam([kin, F._Op("rayl", coef=0.2 * p, c_val=c), sign])
    if kind == "compton":
        return fam([kin, F._Op("compton", coef=0.2 * p, c_val=c,
                               inv_mec2=2.0, kn_xsec=True, kn_tries=12),
                    sign])
    if kind == "compton_thermal":
        return fam([kin, F._Op("compton", coef=0.2 * p, c_val=c,
                               inv_mec2=2.0, kn_xsec=True, kn_tries=12,
                               theta_e=0.02, cols=(0,)),
                    sign])
    if kind == "trace":
        return fam([kin, iso, F._Op("trace", stream0=0, stream_scat=True)],
                   n_stream=4)
    if kind == "trace_bf16":
        return fam([kin, iso, F._Op("trace", stream0=0)], n_stream=3,
                   sdtype="bfloat16")
    if kind == "trace_strided":
        return fam([kin, iso, F._Op("trace", stream0=0, stream_every=4)],
                   n_stream=3)
    if kind == "ecap":
        return fam([kin, iso,
                    F._Op("cross", cols=(1,),
                          axes=((0, 0.5 * L, 2, -1, 0),))], n_stream=1)
    if kind == "custom":
        def fn(v):
            return {"E": v.E * jnp.float32(0.999),
                    "alive": v.uniform() >= jnp.float32(0.01)}

        return fam([kin, F._Op("custom", custom_fn=fn), iso, sign])
    if kind == "reduce":
        def moments(v):
            return {"E_total": v.E,
                    "r2": v.rx * v.rx + v.ry * v.ry + v.rz * v.rz}

        return fam([kin, iso,
                    F._Op("reduce", custom_fn=moments,
                          reduce_outputs=("E_total", "r2"), cols=(1, 0))],
                   n_rec=3)
    if kind == "spectrum_wide":
        edges = tuple(np.linspace(0.0, 2.0, 101))
        names = tuple(f"bin{i}" for i in range(100))

        def hist(v):
            return {f"bin{i}": (v.E >= jnp.float32(edges[i]))
                    & (v.E < jnp.float32(edges[i + 1]))
                    for i in range(100)}

        return fam([kin, F._Op("compton", coef=0.2 * p, c_val=c,
                               inv_mec2=2.0, kn_tries=4),
                    F._Op("reduce", custom_fn=hist, reduce_outputs=names,
                          cols=(1, 0))], n_rec=2)
    if kind == "implicit_capture":
        return fam([kin, F._Op("del", coef=0.3 * p, implicit_capture=True,
                               roulette=(0.2, 0.4), cols=(0,)), sign])
    if kind == "fresnel":
        return fam([kin,
                    F._Op("fresnel", c_val=c,
                          iface=(2, 0.5 * L, 1.0, 1.5, False)),
                    F._Op("fresnel", c_val=c,
                          iface=(2, 1.5 * L, 1.5, 1.0, True)),
                    sign])
    if kind == "lorentz":
        b0 = 0.3 / DT

        def b_fn(x, y, z):
            return (jnp.float32(0.0) * x, jnp.float32(0.0) * x,
                    jnp.float32(b0) + jnp.float32(0.1 * b0 / L) * x)

        return fam([F._Op("lorentz", qm=1.0, b_fn=b_fn), kin, sign],
                   species=OBJ_GENERIC)
    if kind == "lorentz_qm":
        def e_fn(x, y, z):
            return (jnp.float32(0.01 * c / DT) + 0.0 * x, 0.0 * x, 0.0 * x)

        return fam([F._Op("lorentz", qm_plane=F._NF, e_fn=e_fn,
                          b_fn=lambda x, y, z: (0.0 * x, 0.0 * x,
                                                x * 0.0 + 0.3 / DT)),
                    kin, sign], extras=("qm",), species=OBJ_GENERIC)
    if kind == "mixed":
        return fam([F._Op("lorentz", qm=1.0, b_const=(0.0, 0.0, 0.3 / DT)),
                    kin, iso, F._Op("del", coef=0.05 * p), sign],
                   extras=("otype",), species=F.SPECIES_MIXED)
    if kind == "stretch":
        return fam([kin, F._Op("del", coef=0.2 * p,
                               stretch=(0.7, 1.0, 0.0, 0.0), cols=(0,)),
                    sign])
    if kind == "fluorescence":
        return fam([kin, F._Op("del", coef=0.2 * p, c_val=c,
                               fluor=(0.7, 0.5, 0.8), cols=(0,)), sign])
    if kind == "phase":
        mu = np.linspace(-1, 1, 101)
        icdf = light._tabulated_cos_icdf(mu, 1.0 + mu ** 2, bins=64)
        return fam([kin, F._Op("phase", coef=0.2 * p, c_val=c,
                               custom_fn=icdf), sign])
    if kind == "sphere":
        R = 3.0 * L
        return fam([kin, F._Op("scross", sphere=(0.0, 0.0, 0.0, R),
                               cols=(1, 2)),
                    F._Op("sabsorb", sphere=(0.0, 0.0, 0.0, 1.5 * R)),
                    F._Op("sign", cols=(3, 4))])
    if kind == "layered":
        nfn = light.layered_density(np.linspace(-4.0, 4.0, 9) * L,
                                    [1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0, 0.5])
        return fam([kin, F._Op("del", coef=0.05 * p, n_fn=nfn), sign])
    if kind in ("voxel", "voxel_tri", "voxel_ct", "voxel_ct_tri"):
        rng = np.random.default_rng(0)
        interp = "trilinear" if kind.endswith("tri") else "nearest"
        if kind.startswith("voxel_ct"):  # CT-scale 64^3 label grid
            vals = rng.uniform(0.5, 2.0, 200).astype(np.float32)
            grid = vals[rng.integers(0, 200, (64, 64, 64))]
        else:
            grid = rng.uniform(0.5, 2.0, (16, 16, 16)).astype(np.float32)
        n = grid.shape[0]
        nfn = light.voxel_density(grid, origin=(-5 * L,) * 3,
                                  spacing=10 * L / n, interp=interp)
        assert getattr(nfn, "vox_spec", None) is not None
        return fam([kin, F._Op("del", coef=0.05 * p, n_fn=nfn), sign])
    if kind == "kstate":
        def drag(state, ctx):
            return state.replace(v=state.v * 0.999, E=state.E * 0.999)

        return fam([kin, iso, F._Op("kstate", custom_fn=drag)])
    if kind == "extras_write":
        def dosefn(v):
            return {"dose": v.extras["dose"] + v.E * 0.125}

        return fam([kin, iso,
                    F._Op("custom", custom_fn=dosefn,
                          view_extras=(("dose", F._NF, 1),),
                          extras_write=("dose",))],
                   extras=("dose",), writeback=("dose",))
    if kind == "polarized":
        nf = F._NF
        return fam([kin, F._Op("pol", coef=0.2 * p, c_val=c,
                               pol_planes=(nf, nf + 3)),
                    F._Op("polmeas", cols=(1, 0), pol_planes=(nf,),
                          reduce_outputs=("wt", "p", "V", "Q", "U"))],
                   n_rec=2, extras=_POL, writeback=("stokes", "pol_ref"))
    if kind == "polarized_compton":
        nf = F._NF
        return fam([kin, F._Op("polc", coef=0.2 * p, c_val=c,
                               inv_mec2=2.0, kn_xsec=True, kn_tries=12,
                               cols=(0,), pol_planes=(nf, nf + 3)),
                    sign],
                   extras=_POL, writeback=("stokes", "pol_ref"))
    raise ValueError(f"unknown family {kind!r}")


FAMILIES = ("iso", "varn", "emit", "emit_icdf", "hg", "rayl", "compton",
            "compton_thermal", "trace", "trace_strided", "trace_bf16",
            "ecap", "custom", "reduce", "spectrum_wide", "implicit_capture",
            "fresnel", "lorentz", "lorentz_qm", "mixed", "stretch",
            "fluorescence", "phase", "sphere", "layered", "voxel",
            "voxel_tri", "voxel_ct", "voxel_ct_tri", "kstate",
            "extras_write", "polarized", "polarized_compton")


def family_plan(kind: str, chunk: int, **plan_kw) -> F.FusedPlan:
    """The family's FusedPlan (the planner's fixed choices: packed angles,
    polynomial trig); ``plan_kw`` sets launch fields such as tile_rows."""
    ops, n_rec, n_stream, sdtype, extras, writeback, species = \
        family_ops(kind)
    every = max(op.stream_every for op in ops)
    kw = dict(tile_rows=F.KERNEL_TILE_ROWS)
    kw.update(plan_kw)
    return F.FusedPlan(ops=ops, n_rec_cols=n_rec, chunk=chunk,
                       packed_angles=True, fast_trig=True,
                       n_stream=n_stream,
                       stream_every=every if n_stream else 1,
                       stream_dtype=sdtype, extras=extras,
                       extras_writeback=writeback, species=species, **kw)


def family_inputs(plan: F.FusedPlan, capacity: int, seed: int = 0):
    """Seeded chunk inputs ``(packed, sched, emit_starts)``: positions
    uniform in [-4L, 4L]^3, isotropic velocities at c, E in [0.5, 1.5),
    every slot alive with weight 1, the clock at dt per iteration, and an
    emitter filling consecutive 64-slot windows."""
    rng = np.random.default_rng(seed)
    c = _c()
    L = c * DT
    r = rng.uniform(-4 * L, 4 * L, (3, capacity))
    mu = rng.uniform(-1.0, 1.0, capacity)
    phi = rng.uniform(0.0, 2 * np.pi, capacity)
    s = np.sqrt(1.0 - mu * mu)
    v = c * np.stack([s * np.cos(phi), s * np.sin(phi), mu])
    planes = [r, v * DT, v, np.zeros((3, capacity)),
              rng.uniform(0.5, 1.5, (1, capacity)),
              np.ones((1, capacity)), np.ones((1, capacity))]
    for name in plan.extras:
        if name == "otype":
            planes.append((np.arange(capacity) % 2 == 0)[None]
                          * (OBJ_PHOTON - OBJ_GENERIC) + OBJ_GENERIC)
        elif name == "qm":
            planes.append(rng.uniform(0.5, 1.5, (1, capacity)))
        else:
            planes.append(np.zeros((1, capacity)))
    packed = np.concatenate(planes).astype(np.float32)
    K = plan.chunk
    sched = np.full((5, K), DT, np.float32)
    sched[1] = np.cumsum(sched[0])
    sched[2] = sched[1] - sched[0]
    n_emit = max(1, sum(op.kind == "emit" for op in plan.ops))
    emit = ((np.arange(K) * 64) % capacity).astype(np.int32)
    return packed, sched, np.tile(emit, (n_emit, 1))


def compare_chunks(plan: F.FusedPlan, ref, got) -> dict:
    """How far one builder's chunk outputs ``got`` are from ``ref``.

    Tolerances for float32 builders drawing identical random bits, whose
    arithmetic differs only in FMA contraction and the rounding of division,
    square root and reciprocal square root:

    * a photon is *branched* when its alive flag differs or any state plane
      (or stream sample) differs by more than 1e-5*max(1, |x|): a Bernoulli
      threshold flipped on an ulp and the trajectories parted. At most 1e-5
      of the population may branch;
    * integer tallies agree within 1e-5 of the population;
    * float tallies agree within 1e-5 of the column's largest magnitude
      (atomics add in another order).

    Returns the measured quantities and ``ok``."""
    out_a, rec_a, recf_a = (np.asarray(x) for x in ref[:3])
    out_b, rec_b, recf_b = (np.asarray(x) for x in got[:3])
    n = out_a.shape[1]

    def off(a, b, rtol):
        a = a.astype(np.float64)
        b = b.astype(np.float64)
        both_nan = np.isnan(a) & np.isnan(b)
        bad = np.abs(a - b) > rtol * np.maximum(1.0, np.abs(a))
        return (bad | (np.isnan(a) != np.isnan(b))) & ~both_nan

    alive_flip = (out_a[F._ALIVE] > 0) != (out_b[F._ALIVE] > 0)
    branched = alive_flip | off(out_a, out_b, 1e-5).any(axis=0)
    if plan.n_stream:
        # bf16 samples round the same float32 value to one of two
        # neighbours: allow one bf16 ulp
        rtol = 2.0 ** -7 if plan.stream_dtype == "bfloat16" else 1e-5
        sa = np.asarray(ref[3], np.float32)
        sb = np.asarray(got[3], np.float32)
        branched |= off(sa, sb, rtol).any(axis=(0, 1))
    int_err = int(np.abs(rec_a.astype(np.int64) - rec_b).max())
    scale = np.maximum(np.abs(recf_a).max(axis=0), 1e-30)
    float_rel = float((np.abs(recf_a.astype(np.float64) - recf_b)
                       / scale).max())
    res = {"photons": n, "alive_flips": int(alive_flip.sum()),
           "branched": int(branched.sum()), "int_tally_err": int_err,
           "float_tally_rel": float_rel}
    res["ok"] = bool(res["branched"] <= 1e-5 * n
                     and int_err <= 1e-5 * n and float_rel <= 1e-5)
    return res
