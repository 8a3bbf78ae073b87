"""Fused multi-step transport chunk — the performance core.

This replaces the reference's per-step
gather->upload->kernel->download->scatter-back round trip
(physicl/__init__.py:602-664, physicl/light.py:164-205) with one device
program that advances the population through K whole simulation iterations
(time update, kinematics, scattering, deletion, measurement reductions) per
dispatch. Photon independence (README.md:11 of the reference) is what makes
the K-iterations-per-tile schedule legal.

One op body, :func:`_emit_iteration`, and two builders around it:

* ``"triton"`` — a Pallas kernel (``backend="triton"``) for the GPU. Each
  program keeps a block of photons in registers for all K iterations, so
  the state crosses device memory twice per chunk; record tallies leave by
  atomics and stream planes by direct stores.
* ``"xla"`` — the same op body in a ``lax.fori_loop`` compiled by XLA: the
  plain reference, the CPU path, and the GPU path for plans the kernel
  does not cover.

Both draw from the counter-based hash :class:`_Rng` keyed on global slot
coordinates, so they see identical random bits. :func:`choose_builder` makes
the choice at plan time and says why.

Architecture parallel: where the reference's ``CLProgram.build_kernel``
assembles an OpenCL C string from step metadata (physicl/__init__.py:583-597),
``build_plan`` composes traced Python closures from the step list — same slot,
no string codegen, arbitrary user callables (e.g. variable n(r)) trace straight
into the kernel.

The fused path is an optimization with identical observable semantics; the
generic scan engine remains the fallback for step combinations it cannot prove
fusable (path tracing, energy capture, custom steps, untraceable predicates).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from physicl_tpu.state import OBJ_PHOTON, SimState, mod_floor

# Field planes in the packed (NF, C) state array.
(_RX, _RY, _RZ, _DRX, _DRY, _DRZ, _VX, _VY, _VZ, _DVX, _DVY, _DVZ, _E,
 _ALIVE, _W) = range(15)
_NF = 15

# FusedPlan.species sentinel: a mixed photon/generic population — the packed
# "otype" extras plane gates photon physics per particle in-kernel.
SPECIES_MIXED = -1

_LANE = 128
_MAX_REC_COLS = 128


class _Rng:
    """Per-iteration uniform stream shared by every chunk builder.

    A counter-based hash (murmur3 finalizer applied twice) keyed on (seed,
    iteration, static call index, optional salt, GLOBAL element coordinate).
    It is stateless, so it needs no carry through the loop, and a tile that
    starts at global row ``row0`` draws exactly the bits that the
    whole-population XLA chunk draws for the same rows: the Triton kernel
    and the XLA chunk see identical random streams.
    """

    def __init__(self, seed, k, row0=0):
        self.seed = seed
        self.k = k
        self.row0 = row0
        self.idx = 0  # static per-trace call counter

    def bits(self, shape, salt=None):
        """Raw uint32 random bits. ``salt`` (a traced int32) decorrelates
        draws made at the SAME static call site across lax.fori_loop
        iterations."""
        self.idx += 1
        ri = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
              + jnp.asarray(self.row0, jnp.int32).astype(jnp.uint32))
        ci = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
        h = (jnp.asarray(self.seed, jnp.int32).astype(jnp.uint32)
             ^ (jnp.asarray(self.k, jnp.int32).astype(jnp.uint32)
                * jnp.uint32(0x9E3779B9))
             ^ jnp.uint32((self.idx * 0x7FEB352D) & 0xFFFFFFFF))
        if salt is not None:
            h = h ^ (jnp.asarray(salt, jnp.int32).astype(jnp.uint32)
                     * jnp.uint32(0x632BE59B))
        h = h + ri * jnp.uint32(0x85EBCA6B) + ci * jnp.uint32(0xC2B2AE35)
        for mul in (0x85EBCA6B, 0xC2B2AE35):
            h = h ^ (h >> jnp.uint32(16))
            h = h * jnp.uint32(mul)
            h = h ^ (h >> jnp.uint32(13))
        h = h ^ (h >> jnp.uint32(16))
        return h

    def uniform_pair(self, shape, salt=None):
        """Two uniforms from one 32-bit draw (16 bits each)."""
        b = self.bits(shape, salt)
        scale = jnp.float32(1.0 / (1 << 16))
        return ((b >> jnp.uint32(16)).astype(jnp.float32) * scale,
                (b & jnp.uint32(0xFFFF)).astype(jnp.float32) * scale)

    def uniform(self, shape, salt=None):
        """Uniform [0, 1) float32 from the top 24 bits of one draw."""
        return ((self.bits(shape, salt) >> jnp.uint32(8)).astype(jnp.float32)
                * jnp.float32(1.0 / (1 << 24)))


@dataclasses.dataclass
class _Op:
    kind: str  # "kin"|"del"|"iso"|"sign"|"cross"|"emit"|"absorb"|"reflect"|"trace"
    coef: float = 0.0               # folded A*n (del/iso)
    bounds: tuple = ()              # ((lo, hi) per axis,) for absorb/reflect
    # stream planes (device-resident per-iteration per-photon outputs):
    # trace uses planes [p, p+1, p+2] for r and optionally p+3 for scatter
    # flags; cross uses one plane per measured plane for E capture
    stream0: int = -1               # first stream plane this op writes
    stream_scat: bool = False       # trace: also write dv!=0 flags
    stream_every: int = 1           # trace stride: sample every k-th iteration
    # user elementwise physics (engine.ElementwiseStep): traced straight
    # into the kernel over the tile's field planes. "reduce" ops reuse
    # custom_fn for the contribution function and list their output names
    # (declared order = float record channel order from cols[1]).
    custom_fn: Optional[Callable] = None
    after_update: bool = True  # custom op sees t after/before UpdateTimeStep
    reduce_outputs: tuple = ()
    # extras planes a custom/reduce fn declared (engine ElementwiseStep/
    # ReduceMeasureStep extras=): (name, first_plane, rows) per
    # declaration; rows == 1 exposes the plane directly, rows == 3 a
    # tuple of component planes (ParticleView.extras contract)
    view_extras: tuple = ()
    # subset of view_extras base names the custom fn may WRITE (engine
    # ElementwiseStep extras_write=): updates named here store back into
    # the packed planes; the plan lists them in extras_writeback so
    # unpack_state returns them to state.extras each chunk
    extras_write: tuple = ()
    wl_base: Optional[float] = None  # lambda^-4 folding base (iso/hg)
    n_fn: Optional[Callable] = None  # variable n(r) (iso/hg/del)
    a_fn: Optional[Callable] = None  # energy-dependent sigma(E) (del)
    implicit_capture: bool = False  # del: w *= 1-p instead of killing
    roulette: tuple = ()            # del: (w_min, w_survive) or empty
    # del: exponential transform (b, dx, dy, dz) — kill prob biased to
    # p*(1 - b*mu), mu = dr_hat . d; survivors reweight by (1-p)/(1-p')
    stretch: tuple = ()
    # del: fluorescent re-emission (Y, E_f, E_edge) — an absorbed photon
    # with E >= E_edge is re-emitted at E_f true-isotropically (speed
    # c_val) with yield probability Y instead of dying
    fluor: tuple = ()
    c_val: float = 0.0              # |v| for resampled photons (iso/hg)
    g: float = 0.0                  # Henyey-Greenstein anisotropy (hg)
    inv_mec2: float = 0.0           # 1 / (m_e c^2) in code units (compton)
    kn_xsec: bool = False           # scale pcoll by sigma_KN/sigma_T (compton)
    kn_tries: int = 12              # Kahn rejection loop bound (compton)
    theta_e: float = 0.0            # kT_e / m_e c^2 thermal electrons (compton)
    cols: tuple = ()                # record columns (measure ops)
    axes: tuple = ()                # ((axis, L, col), ...) for cross
    # fresnel: (axis, loc, n_lo, n_hi, match_speed) for the refractive
    # plane interface (light.RefractiveInterfaceStep); c_val carries c for
    # match_speed's c/n outgoing speeds
    iface: tuple = ()
    # spherical geometry (scross/sabsorb): (cx, cy, cz, R) folded scalars
    sphere: tuple = ()
    inside: bool = False  # sabsorb: kill ENTRANTS instead of leavers
    # lorentz (newton.LorentzForceStep, charged populations): species-wide
    # charge-to-mass ratio + fields. Constant 3-vector fields arrive as
    # static tuples (e_const/b_const — folded as scalars, full unroll);
    # spatially varying fields as callables over (rx, ry, rz) (e_fn/b_fn —
    # traced per iteration, counted as heavy ops). Per-particle charge/mass
    # instead reads a packed extras plane (plan.extras) at index qm_plane.
    qm: float = 0.0
    qm_plane: int = -1
    e_const: tuple = ()
    b_const: tuple = ()
    e_fn: Optional[Callable] = None
    b_fn: Optional[Callable] = None
    # sign/cross: tallies are statistical-weight sums into FLOAT record
    # channels (cols/axes then index rec_f) instead of int counts
    weighted: bool = False
    # pol/polmeas (polarization.ScatterPolarizedRayleighStep /
    # StokesMeasureStep): absolute packed-plane indices of the first Stokes
    # plane and the first pol_ref plane — (stokes0,) for polmeas (read-only)
    # or (stokes0, pol_ref0) for pol (both triples rewritten in-kernel)
    pol_planes: tuple = ()
    # emit: photons appear in slots [emit_starts[k], +n) each iteration —
    # the schedule is host-precomputed (slot allocation is contiguous from
    # the spawn mark), so in-kernel emission is one masked write per tile.
    emit_n: int = 0
    emit_E: float = 0.0             # constant emitted energy (code units)
    # sampled energies: traced inverse CDF over a uniform (e.g.
    # PlanckSampler.icdf) evaluated on hardware-PRNG draws inside the kernel
    emit_E_fn: Optional[Callable] = None
    emit_r: tuple = (0.0, 0.0, 0.0)
    emit_v: Optional[tuple] = None  # None => isotropic at c_val
    emit_sched_idx: int = 0         # which emit schedule row in dts input
    # polarized source: constant (Q, U, V) + frame row written into the
    # packed Stokes planes for emitted slots (empty = unpolarized)
    emit_stokes: tuple = ()
    emit_polref: tuple = ()


def _view_extras_of(op: _Op, f) -> dict:
    """Packed read-only extras planes -> the ``ParticleView.extras`` mapping
    a custom/reduce fn declared (engine ``extras=`` contract: one array for
    a scalar plane, a tuple of component arrays for a 3-row plane)."""
    return {name: (f[p0] if rows == 1
                   else tuple(f[p0 + i] for i in range(rows)))
            for name, p0, rows in op.view_extras}


@dataclasses.dataclass
class FusedPlan:
    """Static description of one fused chunk."""

    ops: List[_Op]
    n_rec_cols: int
    chunk: int
    # Triton kernel block: tile_rows x 128 photons per program, kept in
    # registers for the whole chunk, over num_warps warps
    tile_rows: int
    num_warps: int = 2
    # which builder compiles the chunk: "xla" (fori_loop over the op body;
    # the plain reference and the CPU path) or "triton" (the GPU kernel).
    # Set by choose_builder at plan time.
    builder: str = "xla"
    # single-species population code the prover validated: OBJ_PHOTON for
    # photon transport (the flagship pipeline) or OBJ_GENERIC for charged /
    # massive particles (kinematics + Lorentz + boundaries + measures).
    # The kernel itself elides per-particle type dispatch either way.
    species: int = OBJ_PHOTON
    # per-particle planes packed AFTER the 15 core planes: names resolve
    # against state.extras at pack time ("qm" is the derived charge-to-mass
    # ratio q/m, 0 where m == 0; "otype" is the species code on mixed
    # plans; "name:i" is row i of a multi-row extras array, e.g. "stokes:0").
    # Ops address extras[j] as field plane _NF + j; the kernel copies them
    # through unchanged unless the base name is listed in extras_writeback.
    extras: tuple = ()
    # base names of extras whose packed planes the kernel MUTATES (e.g. the
    # "pol" op rewrites the Stokes and frame triples): unpack_state
    # reconstructs these into state.extras after every chunk so boundary
    # passes (compaction, injection, checkpoint) see the kernel's writes.
    # Everything not listed stays read-only (single source of truth: host).
    extras_writeback: tuple = ()
    # |dr| == c*dt for every particle (all photons at speed c): replaces the
    # per-photon norm (sqrt + 5 flops) with one scalar per iteration. The
    # prover enables this only after validating every particle speed.
    const_norm_speed: Optional[float] = None
    # draw theta and phi from one 32-bit sample (16 bits each, 2^-16 angular
    # granularity — far below any statistical tolerance) instead of two.
    packed_angles: bool = False
    # polynomial sin/cos on the known [0,1) range (no range reduction):
    # ~1.1e-3 absolute error, renormalized so |v| stays exact.
    fast_trig: bool = False
    # number of per-iteration per-photon output planes (path tracing,
    # per-photon energy capture), written to a device (rows, n, C) buffer:
    # nothing streams to the host until the user asks.
    n_stream: int = 0
    # kernel stream stride: planes are offloaded only on iterations where
    # k % stream_every == 0, into row k // stream_every — the buffer's first
    # dim shrinks to ceil(chunk/stream_every). Set by the fusability prover
    # to the gcd of every stream op's stride (strided path tracing: k-fold
    # fewer stream bytes, so k-fold more iterations fit one dispatch).
    stream_every: int = 1
    # stream element dtype: "bfloat16" halves stream bytes (2x iterations
    # per dispatch for unstrided tracing at large N) at ~0.4% relative
    # position precision (8-bit mantissa; full f32 exponent range, so no
    # overflow and NaN death-encoding still works). Chosen by the prover
    # only when EVERY stream source opts in (TracePathMeasureStep(
    # trace_dtype="bfloat16")) and no per-photon E capture shares the
    # buffer.
    stream_dtype: str = "float32"


def _vox_specs_of(plan: FusedPlan):
    """Ordered, id-deduplicated voxel-table specs referenced by the plan's
    field callables, plus each op's table slot (-1 = none). Both the
    builder (table inputs) and the kernel (ref rebinding) derive the slot
    mapping from this one traversal, so they can never disagree."""
    slots, specs, by_id = [], [], {}
    for op in plan.ops:
        spec = getattr(op.n_fn, "vox_spec", None)
        if spec is None:
            slots.append(-1)
            continue
        key = id(op.n_fn)
        if key not in by_id:
            by_id[key] = len(specs)
            specs.append(spec)
        slots.append(by_id[key])
    return slots, specs


def _round_half_even(x):
    """``jnp.round`` (round half to even) from floor and compares, which
    every chunk builder lowers: exact for every finite f32, so the kernel's
    nearest-voxel index equals :func:`light.voxel_density`'s."""
    r = jnp.floor(x)
    d = x - r
    odd = (r - jnp.float32(2.0) * jnp.floor(r * jnp.float32(0.5))) \
        == jnp.float32(1.0)
    up = (d > 0.5) | ((d == 0.5) & odd)
    return jnp.where(up, r + jnp.float32(1.0), r)


def _vox_table_of(spec: dict):
    """The table a voxel spec reads in-kernel: the flat f32 grid.

    Codebook specs carry the same exact grid values in ``flat``, so one
    direct gather serves both kinds (a 64^3 grid is 1 MiB and stays in
    L2)."""
    return jnp.asarray(np.asarray(spec["flat"], np.float32).reshape(-1))


def _bind_vox_field(spec: dict, tab):
    """The in-kernel twin of ``light.voxel_density``'s callable: same
    index/weight arithmetic in the same order, with the lookup a direct
    gather ``tab[flat]`` from the flat grid (a kernel ref or an array).
    Values are bitwise those of the generic callable."""
    nx, ny, nz = spec["shape"]
    ox, oy, oz = spec["origin"]
    sx, sy, sz = spec["spacing"]
    outside = jnp.float32(spec["outside"])
    trilinear = spec["interp"] == "trilinear"

    def fn(r0, r1, r2):
        fx = (r0 - jnp.float32(ox)) / jnp.float32(sx)
        fy = (r1 - jnp.float32(oy)) / jnp.float32(sy)
        fz = (r2 - jnp.float32(oz)) / jnp.float32(sz)
        if not trilinear:
            inside = ((fx >= -0.5) & (fx < nx - 0.5)
                      & (fy >= -0.5) & (fy < ny - 0.5)
                      & (fz >= -0.5) & (fz < nz - 0.5))
            ix = jnp.clip(_round_half_even(fx).astype(jnp.int32), 0, nx - 1)
            iy = jnp.clip(_round_half_even(fy).astype(jnp.int32), 0, ny - 1)
            iz = jnp.clip(_round_half_even(fz).astype(jnp.int32), 0, nz - 1)
            flat = (ix * jnp.int32(ny) + iy) * jnp.int32(nz) + iz
            return jnp.where(inside, tab[flat], outside)
        inside = ((fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
                  & (fz >= 0) & (fz <= nz - 1))
        x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
        y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
        z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)
        tx = jnp.clip(fx - x0, 0.0, 1.0)
        ty = jnp.clip(fy - y0, 0.0, 1.0)
        tz = jnp.clip(fz - z0, 0.0, 1.0)
        val = jnp.zeros_like(tx)
        for dx_ in (0, 1):
            wx = (1.0 - tx) if dx_ == 0 else tx
            for dy_ in (0, 1):
                wy = (1.0 - ty) if dy_ == 0 else ty
                for dz_ in (0, 1):
                    wz = (1.0 - tz) if dz_ == 0 else tz
                    flat = ((x0 + dx_) * jnp.int32(ny) + (y0 + dy_)) \
                        * jnp.int32(nz) + (z0 + dz_)
                    val = val + wx * wy * wz * tab[flat]
        return jnp.where(inside, val, outside)

    return fn


def _fast_sinpi(y):
    """sin(pi*y) for y in [-1, 1]: parabola + refinement, ~1.1e-3 abs error.

    Statistical physics only needs angle-uniform directions; a 0.06-degree
    worst-case angle error is four orders below the 10% test tolerances.
    """
    p = 4.0 * y * (1.0 - jnp.abs(y))
    return p * (jnp.float32(0.775) + jnp.float32(0.225) * jnp.abs(p))


def _wrap1(x):
    """Map x in [0, 2) (one sine period in pi-units) into [-1, 1)."""
    return x - jnp.where(x > 1.0, jnp.float32(2.0), jnp.float32(0.0))


# Chebyshev-node least-squares fit (degree 8) of log2(1 + t) on [0, 1),
# max abs error 4.9e-8 — same technique as the Planck iCDF fits. Degree 8
# (not 6 at 2.1e-6): _kn_sigma_ratio's exact branch multiplies ln b by
# (1+a)/a^3 = 12 at the a = 0.5 branch switch, and 12 x 2.1e-6 breached
# that function's 2e-5 f64-oracle pin (caught by its test).
_LOG2_MANT_COEF = (
    4.8863580577762396e-08, 1.4426867778259698, -0.7211146144034414,
    0.4783235448682019, -0.34599601243509254, 0.23923166297596724,
    -0.1345342542024613, 0.05027750737261643, -0.008874696651710342)

# degree-5 fit of 2^t on [0, 1), max rel error 1.0e-7
_EXP2_FRAC_COEF = (
    0.9999998957631349, 0.6931546200033143, 0.24014077009166834,
    0.05586328265986017, 0.008946214665550255, 0.0018951072913389714)


def _fast_log2(x):
    """``log2 x`` for positive normal f32 ``x`` with zero transcendentals:
    split ``x = m 2^e`` by exponent-field extraction (bitcast + shifts,
    all Pallas-safe), then ``e + log2 m`` with the degree-8 mantissa
    polynomial above. Uniformly accurate (abs err ~4.9e-8, exact exponent
    term) across the whole normal range — unlike a truncated series, the
    far ends (x -> 2^-126 or 2^127) lose nothing."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = (jax.lax.shift_right_logical(bits, 23) & jnp.int32(0xFF)) \
        - jnp.int32(127)
    m_bits = (bits & jnp.int32(0x007FFFFF)) | jnp.int32(127 << 23)
    t = jax.lax.bitcast_convert_type(m_bits, jnp.float32) - jnp.float32(1.0)
    p = jnp.float32(_LOG2_MANT_COEF[-1])
    for c in _LOG2_MANT_COEF[-2::-1]:
        p = p * t + jnp.float32(c)
    return e.astype(jnp.float32) + p


def _fast_exp2(x):
    """``2^x`` for f32 ``x`` in (-126, 127) with zero transcendentals:
    split ``x = n + f`` (integer floor + fraction in [0, 1)), evaluate
    ``2^f`` with the degree-5 polynomial above (1.0e-7 rel error) and
    scale by ``2^n`` through direct exponent-field construction
    (``(n + 127) << 23`` bitcast to f32 — exact)."""
    n = jnp.floor(x)
    f = x - n
    p = jnp.float32(_EXP2_FRAC_COEF[-1])
    for c in _EXP2_FRAC_COEF[-2::-1]:
        p = p * f + jnp.float32(c)
    scale_bits = jax.lax.shift_left(n.astype(jnp.int32) + jnp.int32(127),
                                    jnp.int32(23))
    return p * jax.lax.bitcast_convert_type(scale_bits, jnp.float32)


def _fast_neg2log(u):
    """``-2 ln u`` for f32 ``u`` in (0, 1] — the Box-Muller radius-squared —
    via :func:`_fast_log2`. Uniformly accurate in ln (abs err ~7e-8),
    so the Maxwell speed tail is as deep as the draw itself reaches
    (u -> 2^-32 is a 6.6-sigma electron and stays exact)."""
    return jnp.float32(-2.0 * np.log(2.0)) * _fast_log2(u)


def _fast_angles(tu, pu):
    """(sin, cos) of theta=2*pi*tu and phi=pi*pu for tu,pu in [0,1)."""
    two_tu = 2.0 * tu
    sin_t = _fast_sinpi(_wrap1(two_tu))
    cos_t = _fast_sinpi(_wrap1(two_tu + jnp.float32(0.5)))
    sin_p = _fast_sinpi(pu)
    cos_p = _fast_sinpi(_wrap1(pu + jnp.float32(0.5)))
    return sin_t, cos_t, sin_p, cos_p


def _kn_triples(rng, plan, shape, tries):
    """Draw the Klein-Nishina Kahn-loop uniforms — one layout for every
    compton variant (cold and thermal) so the samplers can never
    desynchronize. Under packed_angles the (r2, r3) pair shares one
    draw (16-bit halves; acceptance tests, not tail-sensitive). The chain
    is unrolled statically, with every draw up front."""
    triples = []
    for _ in range(tries):
        if plan.packed_angles:
            r1 = rng.uniform(shape)
            r2, r3 = rng.uniform_pair(shape)
        else:
            r1, r2, r3 = (rng.uniform(shape), rng.uniform(shape),
                          rng.uniform(shape))
        triples.append((r1, r2, r3))
    return triples


def _kn_cos_eta_fused(alpha, rng, plan, shape, tries):
    """Klein-Nishina sampler for the fused kernel: up-front unrolled
    draws + the shared unrolled Kahn math (light._kn_cos_eta)."""
    from physicl_tpu.light import _kn_cos_eta

    return _kn_cos_eta(alpha, _kn_triples(rng, plan, shape, tries),
                       jnp.float32, fast=plan.fast_trig)


def _unit_dir(f):
    """Unit velocity direction from the packed field planes."""
    inv_v = jax.lax.rsqrt(jnp.maximum(
        f[_VX] * f[_VX] + f[_VY] * f[_VY] + f[_VZ] * f[_VZ],
        jnp.float32(1e-30)))
    return f[_VX] * inv_v, f[_VY] * inv_v, f[_VZ] * inv_v


def _bisect_phi_sincos(u, a, b, iters: int = 26):
    """(sin phi, cos phi, sin 2phi, cos 2phi) of the polarized-azimuth
    inverse CDF: solve ``phi + (a/2) sin 2phi + (b/2)(1 - cos 2phi) =
    2pi u`` on [0, 2pi] by monotone bisection (the kernel twin of
    polarization._bisect_phi; resolution 2pi*2^-iters — the generic twin
    always bisects 26 deep, the fused packed-angle path stops at 17,
    matching its 16-bit draw).

    Instead of evaluating sin/cos of the midpoint
    each step, carry ``(sin 2*lo, cos 2*lo)`` — the DOUBLE angle, which
    is what the CDF itself needs — and ROTATE by the static interval
    angle ``2*delta_k = pi/2^(k-1)``; the rotation coefficients are
    compile-time f32 constants, so the whole inversion is multiply-adds
    with zero in-loop transcendentals. The constant ``b/2`` term is
    folded into the target (``fv = mid + (a/2) sin2 - (b/2) cos2`` vs
    ``target - b/2``), and the k = 0 rotation (by 2pi) is the identity —
    net 9 fewer model ops per iteration than the half-angle/double-angle
    form this replaces (r5: 669 -> ~540 ops on the pol body).

    The half-angle pair is reconstructed ONCE at the end, cancellation-
    free: the larger of (|sin phi|, |cos phi|) from its well-conditioned
    half-angle sqrt (the argument is >= 1/2 on the selected branch), the
    smaller from ``sin 2phi = 2 sin phi cos phi`` (an exact division by
    the large component, sign riding along); explicit signs come from
    the carried interval endpoint, which is only consulted away from its
    own flip boundaries. f32 rotation drift over 26 composed rotations
    is ~3e-6; the pair is renormalized before extraction. ``iters`` is
    17 for packed-angle draws (the uniform has exactly 16 bits — finer
    bisection refines quantization noise; inversion error < the 9.6e-5
    draw granularity, pinned vs an f64 oracle in
    tests/test_polarization.py) and 26 for full-width draws.
    """
    two_pi = jnp.float32(2.0 * np.pi)
    half = jnp.float32(0.5)
    ha = half * a
    hb = half * b
    target = u * two_pi - hb
    lo = jnp.zeros_like(u)
    s2 = jnp.zeros_like(u)    # sin 2*lo
    c2 = jnp.ones_like(u)     # cos 2*lo
    for k in range(iters):
        delta = np.pi / (1 << k)
        mid = lo + jnp.float32(delta)
        if k == 0:
            s2_m, c2_m = s2, c2   # rotation by 2*delta = 2pi: identity
        else:
            sd = jnp.float32(np.sin(2.0 * delta))
            cd = jnp.float32(np.cos(2.0 * delta))
            s2_m = s2 * cd + c2 * sd
            c2_m = c2 * cd - s2 * sd
        fv = (mid + ha * s2_m) - hb * c2_m
        go_hi = fv < target
        lo = jnp.where(go_hi, mid, lo)
        s2 = jnp.where(go_hi, s2_m, s2)
        c2 = jnp.where(go_hi, c2_m, c2)
    # final midpoint: one more half-interval rotation
    delta = np.pi / (1 << iters)
    sd = jnp.float32(np.sin(2.0 * delta))
    cd = jnp.float32(np.cos(2.0 * delta))
    s2_f = s2 * cd + c2 * sd
    c2_f = c2 * cd - s2 * sd
    phi = lo + jnp.float32(delta)
    # renormalize the pair so the composed-rotation drift cannot leak into
    # the direction/Stokes algebra downstream
    inv = jax.lax.rsqrt(jnp.maximum(s2_f * s2_f + c2_f * c2_f,
                                    jnp.float32(1e-30)))
    s2_f = s2_f * inv
    c2_f = c2_f * inv
    # half-angle extraction (see docstring): cos 2phi >= 0 <=>
    # cos^2 phi >= 1/2, so the sqrt branch chosen is always the
    # well-conditioned one and the division is by a component >= 1/sqrt2
    big_c = c2_f >= 0
    cp_mag = jnp.sqrt((1.0 + c2_f) * half)
    sp_mag = jnp.sqrt((1.0 - c2_f) * half)
    pos1 = jnp.float32(1.0)
    neg1 = jnp.float32(-1.0)
    sign_c = jnp.where((phi < jnp.float32(0.5 * np.pi))
                       | (phi > jnp.float32(1.5 * np.pi)), pos1, neg1)
    sign_s = jnp.where(phi < jnp.float32(np.pi), pos1, neg1)
    cp_big = sign_c * cp_mag
    sp_big = sign_s * sp_mag
    hs2 = s2_f * half
    cos_p = jnp.where(big_c, cp_big,
                      hs2 / jnp.where(big_c, pos1, sp_big))
    sin_p = jnp.where(big_c, hs2 / jnp.where(big_c, cp_big, pos1),
                      sp_big)
    return sin_p, cos_p, s2_f, c2_f


def _emit_iteration(plan: FusedPlan, k, dt, fields, rng: "_Rng",
                    emit_starts_ref=None, gidx=None, t=None):
    """Run one simulation iteration on a tile's field values.

    ``fields`` is a list of (tile_rows, 128) f32 planes; returns (updated
    fields, int record tallies, float record tallies, stream planes), the
    tallies as ``{record column: scalar sum over the tile}`` so a builder
    accumulates only the plan's columns. Ops execute in the plan's
    order == step insertion order (reference semantics,
    physicl/__init__.py:514). ``emit_starts_ref[(op_idx, k)]`` gives emitter
    slot starts (-1 = inactive this iteration); ``gidx`` is each element's
    global slot index.
    """
    f = list(fields)
    row: dict = {}    # int record column -> this tile's tally
    row_f: dict = {}  # float record column -> this tile's tally
    stream: List = [None] * plan.n_stream
    _nan = jnp.float32(np.nan)

    def put(row, col, val):
        return {**row, col: val.astype(jnp.int32)}

    def put_f(row_f, col, val):
        return {**row_f, col: val.astype(jnp.float32)}

    alive_b = f[_ALIVE] > 0
    shape = f[_RX].shape
    # Photon physics gate: on photon-only plans the mask is alive_b itself
    # (no per-particle dispatch — compiles away); on mixed plans the packed
    # otype plane selects the photon subset, matching the generic path's
    # `state.otype == OBJ_PHOTON` filters. Pure-generic plans never carry
    # photon ops (prover refusal). Evaluated per op because alive_b mutates
    # through the pipeline (deletes, roulette, custom kills).
    if plan.species == SPECIES_MIXED:
        is_ph = (f[_NF + plan.extras.index("otype")]
                 == jnp.float32(OBJ_PHOTON))
    else:
        is_ph = None

    def ph_alive():
        return alive_b if is_ph is None else (alive_b & is_ph)

    def dr_norm():
        if plan.const_norm_speed is not None:
            # all particles move at speed c: |dr| = c*dt, one scalar
            return jnp.float32(plan.const_norm_speed) * dt
        return jnp.sqrt(f[_DRX] ** 2 + f[_DRY] ** 2 + f[_DRZ] ** 2)

    for op in plan.ops:
        if op.kind == "kin":
            for d in range(3):
                dr = f[_VX + d] * dt
                f[_DRX + d] = dr
                f[_RX + d] = f[_RX + d] + dr
        elif op.kind == "del":
            pcoll = jnp.float32(op.coef) * dr_norm()
            if op.a_fn is not None:  # energy-dependent cross-section
                pcoll = pcoll * op.a_fn(f[_E]).astype(jnp.float32)
            if op.n_fn is not None:  # variable number density n(r)
                pcoll = pcoll * op.n_fn(f[_RX], f[_RY], f[_RZ]).astype(
                    jnp.float32)
            if op.implicit_capture:
                # survival biasing: deterministic weight decay, no draw
                sel = ph_alive()
                p = jnp.clip(pcoll, jnp.float32(0.0), jnp.float32(1.0))
                if op.cols:  # deposited energy: exact expectation w*p*E
                    row_f = put_f(row_f, op.cols[0], jnp.sum(
                        jnp.where(sel, f[_W] * p * f[_E], 0.0)))
                f[_W] = jnp.where(sel, f[_W] * (jnp.float32(1.0) - p),
                                  f[_W])
                if op.roulette:
                    w_min = jnp.float32(op.roulette[0])
                    w_sur = jnp.float32(op.roulette[1])
                    u = rng.uniform(shape)
                    low = sel & (f[_W] < w_min)
                    kill = low & (u * w_sur >= f[_W])
                    f[_W] = jnp.where(low & jnp.logical_not(kill), w_sur,
                                      f[_W])
                    alive_b = alive_b & jnp.logical_not(kill)
                    f[_ALIVE] = alive_b.astype(jnp.float32)
            elif op.stretch:
                # exponential transform: biased kill + likelihood-ratio
                # reweighting (mirrors the generic apply exactly)
                u = rng.uniform(shape)
                sel = ph_alive()
                tiny = jnp.float32(1e-30)
                b, dx, dy, dz = (jnp.float32(x) for x in op.stretch)
                mu = ((f[_DRX] * dx + f[_DRY] * dy + f[_DRZ] * dz)
                      / jnp.maximum(dr_norm(), tiny))
                one = jnp.float32(1.0)
                p_true = jnp.clip(pcoll, jnp.float32(0.0), one)
                p_bias = jnp.clip(pcoll * (one - b * mu),
                                  jnp.float32(0.0), one)
                # cap saturating biased kills (p_true < 1 must keep a
                # survivor branch or its weight is lost — see the generic
                # apply's comment; bound: 8x weight amplification)
                p_bias = jnp.where(p_true < one,
                                   jnp.minimum(p_bias,
                                               jnp.float32(7.0 / 8.0)),
                                   p_bias)
                hit = (p_bias >= u) & sel
                ratio = (one - p_true) / jnp.maximum(one - p_bias, tiny)
                f[_W] = jnp.where(sel & jnp.logical_not(hit),
                                  f[_W] * ratio, f[_W])
                if op.cols:
                    row_f = put_f(row_f, op.cols[0], jnp.sum(jnp.where(
                        hit, f[_W] * f[_E]
                        * (p_true / jnp.maximum(p_bias, tiny)), 0.0)))
                alive_b = alive_b & jnp.logical_not(hit)
                f[_ALIVE] = alive_b.astype(jnp.float32)
            elif op.fluor:
                # fluorescent re-emission: absorbed photons above the edge
                # re-emit at the line energy with yield probability Y
                # (mirrors the generic apply's branch exactly)
                u = rng.uniform(shape)
                hit = (pcoll >= u) & ph_alive()
                Y, E_f, E_edge = (jnp.float32(x) for x in op.fluor)
                y = rng.uniform(shape)
                if plan.packed_angles:
                    cu, au = rng.uniform_pair(shape)
                else:
                    cu, au = rng.uniform(shape), rng.uniform(shape)
                fluo = hit & (y < Y) & (f[_E] >= E_edge)
                killed = hit & jnp.logical_not(fluo)
                if op.cols:  # deficit for re-emitted, all of E for killed
                    row_f = put_f(row_f, op.cols[0], jnp.sum(jnp.where(
                        killed, f[_W] * f[_E], jnp.where(
                            fluo, f[_W] * (f[_E] - E_f),
                            jnp.float32(0.0)))))
                # TRUE isotropic (physical emission; cos-theta uniform —
                # not the scatter family's reference-parity convention)
                cos_t = 2.0 * cu - jnp.float32(1.0)
                sin_t = jnp.sqrt(jnp.maximum(
                    jnp.float32(1.0) - cos_t * cos_t, jnp.float32(0.0)))
                two_au = 2.0 * au
                sin_a = _fast_sinpi(_wrap1(two_au))
                cos_a = _fast_sinpi(_wrap1(two_au + jnp.float32(0.5)))
                nx, ny, nz = sin_t * cos_a, sin_t * sin_a, cos_t
                inv = jax.lax.rsqrt(jnp.maximum(
                    nx * nx + ny * ny + nz * nz, jnp.float32(1e-30)))
                cval = jnp.float32(op.c_val) * inv
                vnew = (cval * nx, cval * ny, cval * nz)
                for d in range(3):
                    old = f[_VX + d]
                    f[_VX + d] = jnp.where(fluo, vnew[d], old)
                    # dv only on re-emitted lanes: upstream scatter flags
                    # from this iteration must survive (plain del never
                    # touches dv)
                    f[_DVX + d] = jnp.where(fluo, vnew[d] - old,
                                            f[_DVX + d])
                f[_E] = jnp.where(fluo, E_f, f[_E])
                # fluorescence light is unpolarized: zero Stokes/frame
                # planes of re-emitted lanes (matches the generic apply)
                for j, name in enumerate(plan.extras):
                    if name.split(":")[0] in ("stokes", "pol_ref"):
                        f[_NF + j] = jnp.where(fluo, jnp.float32(0.0),
                                               f[_NF + j])
                alive_b = alive_b & jnp.logical_not(killed)
                f[_ALIVE] = alive_b.astype(jnp.float32)
            else:
                u = rng.uniform(shape)
                hit = (pcoll >= u) & ph_alive()
                if op.cols:  # deposited energy: killed photons dump w*E
                    row_f = put_f(row_f, op.cols[0], jnp.sum(
                        jnp.where(hit, f[_W] * f[_E], 0.0)))
                alive_b = alive_b & jnp.logical_not(hit)
                f[_ALIVE] = alive_b.astype(jnp.float32)
        elif op.kind == "iso":
            pcoll = jnp.float32(op.coef) * dr_norm()
            if op.n_fn is not None:
                pcoll = pcoll * op.n_fn(f[_RX], f[_RY], f[_RZ]).astype(
                    jnp.float32
                )
            if op.wl_base is not None:
                base = f[_E] * jnp.float32(op.wl_base)
                b2 = base * base
                pcoll = pcoll * (b2 * b2)
            u = rng.uniform(shape)
            if plan.packed_angles:
                tu, pu = rng.uniform_pair(shape)
            else:
                tu, pu = rng.uniform(shape), rng.uniform(shape)
            scatter = (pcoll >= u) & ph_alive()
            if plan.fast_trig:
                sin_t, cos_t, sin_p, cos_p = _fast_angles(tu, pu)
                # renormalize so |v| stays exactly the particle speed
                nx, ny, nz = sin_t * cos_p, sin_t * sin_p, cos_t
                inv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
                cval = jnp.float32(op.c_val) * inv
                vnew = (cval * nx, cval * ny, cval * nz)
            else:
                theta = tu * jnp.float32(2 * np.pi)
                phi = pu * jnp.float32(np.pi)
                sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
                sin_p, cos_p = jnp.sin(phi), jnp.cos(phi)
                cval = jnp.float32(op.c_val)
                vnew = (cval * sin_t * cos_p, cval * sin_t * sin_p,
                        cval * cos_t)
            for d in range(3):
                old = f[_VX + d]
                f[_VX + d] = jnp.where(scatter, vnew[d], old)
                f[_DVX + d] = jnp.where(scatter, vnew[d] - old,
                                        jnp.float32(0.0))
        elif op.kind == "compton" and op.theta_e > 0.0:
            # Thermal Comptonization: Maxwell electron draw, relativistic
            # flux-weighted collision rate, exact KN in the electron frame
            # (light._ic_thermal_scatter does the boosts + rotation; the
            # Kompaneets drift <dE/E> = 4 theta_e - alpha emerges)
            from physicl_tpu.light import _ic_thermal_scatter, \
                _kn_sigma_ratio

            pcoll = jnp.float32(op.coef) * dr_norm()
            if op.n_fn is not None:
                pcoll = pcoll * op.n_fn(f[_RX], f[_RY], f[_RZ]).astype(
                    jnp.float32)
            u = rng.uniform(shape)
            pu = rng.uniform(shape)
            # Box-Muller RADIUS uniforms (u4[0], u4[2]) need full-precision
            # draws: 16-bit pair halves truncate the Maxwell speed tail at
            # 4.7 sigma (with a clamp atom at 7.4) where the generic path
            # reaches 5.8 — angles (u4[1], u4[3]) are tail-insensitive
            if plan.packed_angles:
                a1, a2 = rng.uniform_pair(shape)
                u4 = (rng.uniform(shape), a1, rng.uniform(shape), a2)
            else:
                u4 = tuple(rng.uniform(shape) for _ in range(4))
            nhat = _unit_dir(f)
            E_new, n_new, alpha1, flux, kn_ok = _ic_thermal_scatter(
                f[_E], nhat, op.inv_mec2, op.theta_e, u4,
                lambda a1: _kn_cos_eta_fused(a1, rng, plan, shape,
                                            op.kn_tries), pu,
                jnp.float32, fast_trig=plan.fast_trig)
            pcoll = pcoll * flux
            if op.kn_xsec:
                pcoll = pcoll * _kn_sigma_ratio(alpha1, jnp.float32,
                                                fast=plan.fast_trig)
            scatter = (pcoll >= u) & ph_alive() & kn_ok
            cval = jnp.float32(op.c_val)
            for d in range(3):
                old = f[_VX + d]
                f[_VX + d] = jnp.where(scatter, n_new[d] * cval, old)
                f[_DVX + d] = jnp.where(scatter, n_new[d] * cval - old,
                                        jnp.float32(0.0))
            if op.cols:  # Compton heating: net energy to electrons
                # (signed: negative when inverse Compton pumps photons)
                row_f = put_f(row_f, op.cols[0], jnp.sum(
                    jnp.where(scatter, f[_W] * (f[_E] - E_new), 0.0)))
            f[_E] = jnp.where(scatter, E_new, f[_E])
        elif op.kind in ("hg", "rayl", "compton", "phase"):
            # Anisotropic scatter: same collision model as "iso", outgoing
            # direction drawn RELATIVE to the incoming one. "hg": exact
            # Henyey-Greenstein inverse CDF (<cos theta> == g). "rayl":
            # exact Rayleigh dipole phase (3/8)(1+cos^2) via the Cardano
            # closed form (light._rayleigh_cos_theta; <cos^2 theta> == 2/5).
            # "compton": exact Klein-Nishina (Kahn/Koblinger per-photon
            # selection, light._kn_cos_eta) + the E' = E/eta recoil shift —
            # the only op that rewrites the energy plane in-flight.
            pcoll = jnp.float32(op.coef) * dr_norm()
            if op.n_fn is not None:
                pcoll = pcoll * op.n_fn(f[_RX], f[_RY], f[_RZ]).astype(
                    jnp.float32)
            if op.wl_base is not None:
                base = f[_E] * jnp.float32(op.wl_base)
                b2 = base * base
                pcoll = pcoll * (b2 * b2)
            eta = None
            if op.kind == "compton":
                from physicl_tpu.light import _kn_sigma_ratio

                alpha = f[_E] * jnp.float32(op.inv_mec2)
                if op.kn_xsec:
                    pcoll = pcoll * _kn_sigma_ratio(
                        alpha, jnp.float32, fast=plan.fast_trig)
                u = rng.uniform(shape)
                pu = rng.uniform(shape)
                cos_t, eta, kn_ok = _kn_cos_eta_fused(alpha, rng, plan,
                                                     shape, op.kn_tries)
                scatter = (pcoll >= u) & ph_alive() & kn_ok
            else:
                u = rng.uniform(shape)
                if plan.packed_angles:
                    cu, pu = rng.uniform_pair(shape)
                else:
                    cu, pu = rng.uniform(shape), rng.uniform(shape)
                scatter = (pcoll >= u) & ph_alive()
            if op.kind == "compton":
                pass  # cos_t already sampled above
            elif op.kind == "phase":
                # user inverse CDF traced into the kernel (gather-free by
                # contract: callable or the tabulated mask-multiply form)
                cos_t = jnp.clip(op.custom_fn(cu).astype(jnp.float32),
                                 jnp.float32(-1.0), jnp.float32(1.0))
            elif op.kind == "rayl":
                from physicl_tpu.light import _rayleigh_cos_theta

                cos_t = _rayleigh_cos_theta(cu, jnp.float32,
                                            fast=plan.fast_trig)
            elif abs(op.g) < 1e-7:
                cos_t = 2.0 * cu - 1.0  # exact isotropic limit
            else:
                gg = jnp.float32(op.g)
                s = (1.0 - gg * gg) / (1.0 - gg + 2.0 * gg * cu)
                cos_t = jnp.clip((1.0 + gg * gg - s * s) / (2.0 * gg),
                                 jnp.float32(-1.0), jnp.float32(1.0))
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t,
                                         jnp.float32(0.0)))
            if plan.fast_trig:
                two_pu = 2.0 * pu
                sin_p = _fast_sinpi(_wrap1(two_pu))
                cos_p = _fast_sinpi(_wrap1(two_pu + jnp.float32(0.5)))
                # normalize the azimuth pair: the ~1e-3 polynomial norm
                # error would otherwise leak into the POLAR angle through
                # the final renormalization (skewing cos_theta by ~1e-4 —
                # for compton that breaks the exact E'-angle relation)
                inv_p = jax.lax.rsqrt(sin_p * sin_p + cos_p * cos_p)
                sin_p = sin_p * inv_p
                cos_p = cos_p * inv_p
            else:
                phi = pu * jnp.float32(2 * np.pi)
                sin_p, cos_p = jnp.sin(phi), jnp.cos(phi)
            # unit incoming direction; branch-free orthonormal basis
            # (Duff et al. 2017), robust incl. +-z
            inv_v = jax.lax.rsqrt(jnp.maximum(
                f[_VX] * f[_VX] + f[_VY] * f[_VY] + f[_VZ] * f[_VZ],
                jnp.float32(1e-30)))
            dx, dy, dz = (f[_VX] * inv_v, f[_VY] * inv_v, f[_VZ] * inv_v)
            sign = jnp.where(dz >= 0, jnp.float32(1.0), jnp.float32(-1.0))
            a = -1.0 / (sign + dz)
            b = dx * dy * a
            e1 = (1.0 + sign * dx * dx * a, sign * b, -sign * dx)
            e2 = (b, sign + dy * dy * a, -dy)
            n_new = tuple(
                cos_t * dd + sin_t * (cos_p * uu + sin_p * ww)
                for dd, uu, ww in zip((dx, dy, dz), e1, e2))
            # renormalize so |v| stays exactly the particle speed
            inv_n = jax.lax.rsqrt(n_new[0] * n_new[0] + n_new[1] * n_new[1]
                                  + n_new[2] * n_new[2])
            cval = jnp.float32(op.c_val) * inv_n
            for d in range(3):
                old = f[_VX + d]
                f[_VX + d] = jnp.where(scatter, n_new[d] * cval, old)
                f[_DVX + d] = jnp.where(scatter, n_new[d] * cval - old,
                                        jnp.float32(0.0))
            if eta is not None:  # Compton recoil: E' = E / eta
                if op.cols:  # heating tally: w * (E - E') over scatters
                    row_f = put_f(row_f, op.cols[0], jnp.sum(jnp.where(
                        scatter, f[_W] * (f[_E] - f[_E] / eta), 0.0)))
                f[_E] = jnp.where(scatter, f[_E] / eta, f[_E])
        elif op.kind in ("pol", "polc"):
            # Stokes-polarized scatter (polarization module): "pol" is
            # Rayleigh/Thomson (dipole theta marginal, kappa = 2), "polc"
            # is Compton (Klein-Nishina theta + Fano matrix with
            # kappa = eta + 1/eta and the E' = E/eta recoil). (theta, phi)
            # are drawn from the FULL polarized intensity; the Stokes +
            # frame triples (packed extras planes, writeback) rewrite per
            # scatter. Mirrors the generic _apply_phase_matrix exactly
            # (same masks, clips, frame fallback) up to PRNG stream and
            # the bisection's in-kernel trig recurrences.
            from physicl_tpu.light import (_kn_sigma_ratio,
                                           _rayleigh_cos_theta)

            st_p, pr_p = op.pol_planes
            pcoll = jnp.float32(op.coef) * dr_norm()
            if op.n_fn is not None:
                pcoll = pcoll * op.n_fn(f[_RX], f[_RY], f[_RZ]).astype(
                    jnp.float32)
            if op.wl_base is not None:
                base = f[_E] * jnp.float32(op.wl_base)
                b2 = base * base
                pcoll = pcoll * (b2 * b2)
            eta = None
            if op.kind == "polc":
                alpha = f[_E] * jnp.float32(op.inv_mec2)
                if op.kn_xsec:
                    pcoll = pcoll * _kn_sigma_ratio(
                        alpha, jnp.float32, fast=plan.fast_trig)
                u = rng.uniform(shape)
                pu = rng.uniform(shape)
                cos_t, eta, kn_ok = _kn_cos_eta_fused(alpha, rng, plan,
                                                     shape, op.kn_tries)
                kappa = eta + 1.0 / eta
                scatter = (pcoll >= u) & ph_alive() & kn_ok
            else:
                u = rng.uniform(shape)
                if plan.packed_angles:
                    cu, pu = rng.uniform_pair(shape)
                else:
                    cu, pu = rng.uniform(shape), rng.uniform(shape)
                kappa = jnp.float32(2.0)
                scatter = (pcoll >= u) & ph_alive()

            # local right-handed frame (e1, e2, d): stored pol_ref
            # re-orthonormalized against d, fresh perpendicular where
            # degenerate (zero-filled slots / unpolarized injections)
            dx, dy, dz = _unit_dir(f)
            q = f[st_p]
            u_st = f[st_p + 1]
            v_st = f[st_p + 2]
            dot = dx * f[pr_p] + dy * f[pr_p + 1] + dz * f[pr_p + 2]
            p0 = f[pr_p] - dot * dx
            p1 = f[pr_p + 1] - dot * dy
            p2 = f[pr_p + 2] - dot * dz
            n2 = p0 * p0 + p1 * p1 + p2 * p2
            inv_n = jax.lax.rsqrt(jnp.maximum(n2, jnp.float32(1e-30)))
            # fallback: z-hat where |dz| < 0.9 else y-hat, orthonormalized
            # (generic path's _perp_candidate + _orthonormal_ref)
            use_z = jnp.abs(dz) < jnp.float32(0.9)
            cy = jnp.where(use_z, jnp.float32(0.0), jnp.float32(1.0))
            cz = jnp.where(use_z, jnp.float32(1.0), jnp.float32(0.0))
            dotc = dy * cy + dz * cz
            fb0 = -dotc * dx
            fb1 = cy - dotc * dy
            fb2 = cz - dotc * dz
            inv_fb = jax.lax.rsqrt(jnp.maximum(
                fb0 * fb0 + fb1 * fb1 + fb2 * fb2, jnp.float32(1e-30)))
            degen = n2 < jnp.float32(1e-8)  # == (norm < 1e-4) generically
            e1x = jnp.where(degen, fb0 * inv_fb, p0 * inv_n)
            e1y = jnp.where(degen, fb1 * inv_fb, p1 * inv_n)
            e1z = jnp.where(degen, fb2 * inv_fb, p2 * inv_n)
            # (e2 = d x e1 is computed after the azimuth inversion below —
            # three fewer planes live across the bisection loop)

            # theta: dipole marginal (pol, Cardano) already or KN (polc,
            # sampled above); then phi | theta from the exact conditional
            # 1 + a cos2phi + b sin2phi by recurrence bisection, with
            # r = -sin^2/(kappa - sin^2) (kappa = 2 == the dipole limit)
            if op.kind == "pol":
                cos_t = _rayleigh_cos_theta(cu, jnp.float32,
                                            fast=plan.fast_trig)
            c2 = cos_t * cos_t
            s2_ = 1.0 - c2
            r_t = -s2_ / (kappa - s2_)
            # packed angles give pu exactly 16 bits: bisecting past
            # 2pi*2^-17 refines quantization noise (polc draws a full-
            # width uniform and keeps the 26-step resolution)
            phi_iters = (17 if op.kind == "pol" and plan.packed_angles
                         else 26)
            sin_p, cos_p, sin2p, cos2p = _bisect_phi_sincos(
                pu, r_t * q, r_t * u_st, iters=phi_iters)

            # rotate Stokes into the scattering plane, apply the Fano
            # phase matrix (Thomson rows at kappa = 2), renormalize to I=1
            q_r = q * cos2p + u_st * sin2p
            u_r = u_st * cos2p - q * sin2p
            i_new = (kappa - s2_) - s2_ * q_r
            inv_i = 1.0 / jnp.maximum(i_new, jnp.float32(1e-7))
            one = jnp.float32(1.0)
            neg1 = jnp.float32(-1.0)  # the Triton route cannot negate a literal
            q_new = jnp.clip((-s2_ + (1.0 + c2) * q_r) * inv_i, neg1, one)
            u_new = jnp.clip(2.0 * cos_t * u_r * inv_i, neg1, one)
            v_new_st = jnp.clip(kappa * cos_t * v_st * inv_i, neg1, one)
            # over-purity clamp near the Mueller null (generic twin does
            # the same): rescale only when f32 roundoff pushed p past 1
            pp2 = q_new * q_new + u_new * u_new + v_new_st * v_new_st
            pscale = jax.lax.rsqrt(jnp.maximum(pp2, one))
            q_new = q_new * pscale
            u_new = u_new * pscale
            v_new_st = v_new_st * pscale

            # new direction d' = cos_t d + sin_t a, frame e1' = cos_t a -
            # sin_t d (a = cos_p e1 + sin_p e2); both renormalized
            sin_t = jnp.sqrt(jnp.maximum(1.0 - c2, jnp.float32(0.0)))
            e2x = dy * e1z - dz * e1y
            e2y = dz * e1x - dx * e1z
            e2z = dx * e1y - dy * e1x
            ax_ = cos_p * e1x + sin_p * e2x
            ay_ = cos_p * e1y + sin_p * e2y
            az_ = cos_p * e1z + sin_p * e2z
            ndx = cos_t * dx + sin_t * ax_
            ndy = cos_t * dy + sin_t * ay_
            ndz = cos_t * dz + sin_t * az_
            inv_dn = jax.lax.rsqrt(jnp.maximum(
                ndx * ndx + ndy * ndy + ndz * ndz, jnp.float32(1e-30)))
            cval = jnp.float32(op.c_val) * inv_dn
            for d_i, nd in enumerate((ndx, ndy, ndz)):
                old = f[_VX + d_i]
                f[_VX + d_i] = jnp.where(scatter, nd * cval, old)
                f[_DVX + d_i] = jnp.where(scatter, nd * cval - old,
                                          jnp.float32(0.0))
            n1x = cos_t * ax_ - sin_t * dx
            n1y = cos_t * ay_ - sin_t * dy
            n1z = cos_t * az_ - sin_t * dz
            inv_e1 = jax.lax.rsqrt(jnp.maximum(
                n1x * n1x + n1y * n1y + n1z * n1z, jnp.float32(1e-30)))
            # non-scattering slots keep the RE-ORTHONORMALIZED frame (the
            # generic path stores it back every iteration, which is what
            # stops f32 frame drift from accumulating)
            f[st_p] = jnp.where(scatter, q_new, q)
            f[st_p + 1] = jnp.where(scatter, u_new, u_st)
            f[st_p + 2] = jnp.where(scatter, v_new_st, v_st)
            f[pr_p] = jnp.where(scatter, n1x * inv_e1, e1x)
            f[pr_p + 1] = jnp.where(scatter, n1y * inv_e1, e1y)
            f[pr_p + 2] = jnp.where(scatter, n1z * inv_e1, e1z)
            if eta is not None:  # polc: Compton recoil E' = E / eta
                if op.cols:  # heating tally: w * (E - E') over scatters
                    row_f = put_f(row_f, op.cols[0], jnp.sum(jnp.where(
                        scatter, f[_W] * (f[_E] - f[_E] / eta), 0.0)))
                f[_E] = jnp.where(scatter, f[_E] / eta, f[_E])
        elif op.kind == "polmeas":
            # polarization summary (polarization.StokesMeasureStep): weight,
            # degree-of-polarization, and Stokes component sums over alive
            # photons into float record channels; the host divides by the
            # weight sum to recover the generic path's means (tile sums add
            # across the grid and psum across shards)
            (st_p,) = op.pol_planes
            n_col, f0 = op.cols
            if n_col >= 0:
                row = put(row, n_col, jnp.sum(alive_b, dtype=jnp.int32))
            # ALL alive particles, matching the generic apply's state.alive
            # weighting (not photon-gated)
            wt = alive_b.astype(jnp.float32)
            if op.weighted:
                wt = wt * f[_W]
            qs, us, vs = f[st_p], f[st_p + 1], f[st_p + 2]
            pdeg = jnp.sqrt(qs * qs + us * us + vs * vs)
            row_f = put_f(row_f, f0, jnp.sum(wt))
            row_f = put_f(row_f, f0 + 1, jnp.sum(wt * pdeg))
            row_f = put_f(row_f, f0 + 2, jnp.sum(wt * vs))
            if len(op.reduce_outputs) > 3:  # local_qu: <Q>, <U>
                row_f = put_f(row_f, f0 + 3, jnp.sum(wt * qs))
                row_f = put_f(row_f, f0 + 4, jnp.sum(wt * us))
        elif op.kind == "emit":
            # inactive iterations use a far-negative start (never overlaps);
            # under shard_map starts are shifted into shard-local coordinates
            # and a window crossing a shard boundary is written piecewise
            start = emit_starts_ref[op.emit_sched_idx, k]
            mask = (gidx >= start) & (gidx < start + op.emit_n)
            if op.emit_E_fn is not None:  # in-kernel sampled energies
                E_new = op.emit_E_fn(rng.uniform(shape))
                f[_E] = jnp.where(mask, E_new, f[_E])
            else:
                f[_E] = jnp.where(mask, jnp.float32(op.emit_E), f[_E])
            for d in range(3):
                f[_RX + d] = jnp.where(mask, jnp.float32(op.emit_r[d]),
                                       f[_RX + d])
                f[_DRX + d] = jnp.where(mask, jnp.float32(0.0), f[_DRX + d])
                f[_DVX + d] = jnp.where(mask, jnp.float32(0.0), f[_DVX + d])
            if op.emit_v is not None:
                for d in range(3):
                    f[_VX + d] = jnp.where(mask, jnp.float32(op.emit_v[d]),
                                           f[_VX + d])
            else:  # isotropic directions at speed c_val
                tu, pu = rng.uniform_pair(shape)
                sin_t, cos_t, sin_p, cos_p = _fast_angles(tu, pu)
                nx, ny, nz = sin_t * cos_p, sin_t * sin_p, cos_t
                inv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
                cval = jnp.float32(op.c_val) * inv
                for d, comp in enumerate((nx, ny, nz)):
                    f[_VX + d] = jnp.where(mask, cval * comp, f[_VX + d])
            # recycled slots may carry a stale roulette/capture weight
            f[_W] = jnp.where(mask, jnp.float32(1.0), f[_W])
            # ... and stale per-particle aux planes (Stokes vectors, charge
            # data): fresh photons start with zeroed extras (unpolarized,
            # degenerate frame -> fallback on first polarized scatter) —
            # except a polarized source's configured Stokes/frame rows —
            # matching the generic PhotonEmitterStep's extras reset. The
            # derived otype plane is handled below, never zeroed.
            emit_fill = {}
            if op.emit_stokes:
                for i_, base in ((0, "stokes"), (1, "pol_ref")):
                    vals = (op.emit_stokes, op.emit_polref)[i_]
                    for r_ in range(3):
                        emit_fill[f"{base}:{r_}"] = jnp.float32(vals[r_])
            for j, name in enumerate(plan.extras):
                if name != "otype":
                    f[_NF + j] = jnp.where(
                        mask, emit_fill.get(name, jnp.float32(0.0)),
                        f[_NF + j])
            if is_ph is not None and plan.species == SPECIES_MIXED:
                # emitted slots become photons in the packed otype plane so
                # same-chunk photon physics sees them immediately (the host
                # retypes state.otype from the emit schedule at harvest)
                p = _NF + plan.extras.index("otype")
                f[p] = jnp.where(mask, jnp.float32(OBJ_PHOTON), f[p])
                is_ph = f[p] == jnp.float32(OBJ_PHOTON)
            alive_b = alive_b | mask
            f[_ALIVE] = alive_b.astype(jnp.float32)
        elif op.kind == "absorb":
            # kill particles that left the box (newton.AbsorbingBoundaryStep)
            inside = None
            for d, (lo, hi) in enumerate(op.bounds):
                ok = (f[_RX + d] >= jnp.float32(lo)) & (
                    f[_RX + d] <= jnp.float32(hi))
                inside = ok if inside is None else (inside & ok)
            alive_b = alive_b & inside
            f[_ALIVE] = alive_b.astype(jnp.float32)
        elif op.kind == "periodic":
            # wrap-around box (newton.PeriodicBoundaryStep): r folds into
            # [lo, hi) by modulo; velocity and dr untouched
            for d, (lo, hi) in enumerate(op.bounds):
                lo_f = jnp.float32(lo)
                L = jnp.float32(hi) - lo_f
                f[_RX + d] = lo_f + mod_floor(f[_RX + d] - lo_f, L)
        elif op.kind == "reflect":
            # triangle-wave fold per axis (newton.ReflectingBoundaryStep):
            # handles arbitrary overshoot; odd fold parity flips the velocity
            for d, (lo, hi) in enumerate(op.bounds):
                lo_f, hi_f = jnp.float32(lo), jnp.float32(hi)
                L = hi_f - lo_f
                r0 = f[_RX + d]
                y = mod_floor(r0 - lo_f, 2 * L)
                odd = y > L
                folded = lo_f + jnp.where(odd, 2 * L - y, y)
                outside = (r0 > hi_f) | (r0 < lo_f)
                r1 = jnp.where(outside, folded, r0)
                f[_VX + d] = jnp.where(outside & odd, -f[_VX + d],
                                       f[_VX + d])
                f[_DRX + d] = r1 - (r0 - f[_DRX + d])
                f[_RX + d] = r1
        elif op.kind == "lorentz":
            # Boris pusher (newton.LorentzForceStep): half-E kick, exact
            # B rotation, half-E kick — |v| exactly conserved in pure B.
            # qm_plane >= 0 reads per-particle q/m from a packed extras
            # plane. dt is the value the GENERIC path exposes at this step's
            # position vs UpdateTimeStep (sched rows 3/4), not kinematics'.
            if t is None:
                dt_l = dt
            else:
                dt_l = t[2] if op.after_update else t[3]
            if op.qm_plane >= 0:
                h = f[op.qm_plane] * (jnp.float32(0.5) * dt_l)
            else:
                h = jnp.float32(0.5 * op.qm) * dt_l
            has_e = op.e_fn is not None or op.e_const
            if has_e:
                ef = (op.e_const if op.e_const
                      else op.e_fn(f[_RX], f[_RY], f[_RZ]))
                ev = [jnp.asarray(x, jnp.float32) * h for x in ef]
                vx = f[_VX] + ev[0]
                vy = f[_VY] + ev[1]
                vz = f[_VZ] + ev[2]
            else:
                vx, vy, vz = f[_VX], f[_VY], f[_VZ]
            if op.b_fn is not None or op.b_const:
                bf = (op.b_const if op.b_const
                      else op.b_fn(f[_RX], f[_RY], f[_RZ]))
                tx, ty, tz = (jnp.asarray(x, jnp.float32) * h for x in bf)
                vpx = vx + (vy * tz - vz * ty)
                vpy = vy + (vz * tx - vx * tz)
                vpz = vz + (vx * ty - vy * tx)
                s2 = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
                vx = vx + s2 * (vpy * tz - vpz * ty)
                vy = vy + s2 * (vpz * tx - vpx * tz)
                vz = vz + s2 * (vpx * ty - vpy * tx)
            if has_e:
                vx, vy, vz = vx + ev[0], vy + ev[1], vz + ev[2]
            # push = alive non-photons: in mixed plans the otype plane
            # excludes photons (generic parity: photons immune, dv zeroed)
            push = (alive_b if is_ph is None
                    else alive_b & jnp.logical_not(is_ph))
            for d, vn in enumerate((vx, vy, vz)):
                new = jnp.where(push, vn, f[_VX + d])
                f[_DVX + d] = new - f[_VX + d]
                f[_VX + d] = new
        elif op.kind == "fresnel":
            # refractive plane interface (light.RefractiveInterfaceStep):
            # Fresnel-reflect or Snell-refract photons whose segment
            # [r-dr, r] crossed r[axis] == loc; the remainder of the step
            # retraces from the intersection in the outgoing direction
            ax, loc, n_lo, n_hi, match = op.iface
            loc_f = jnp.float32(loc)
            z1 = f[_RX + ax]
            z0 = z1 - f[_DRX + ax]
            side0 = z0 >= loc_f
            crossed = (side0 != (z1 >= loc_f)) & ph_alive()
            inv_speed = jax.lax.rsqrt(jnp.maximum(
                f[_VX] * f[_VX] + f[_VY] * f[_VY] + f[_VZ] * f[_VZ],
                jnp.float32(1e-30)))
            d = [f[_VX + dd] * inv_speed for dd in range(3)]
            going_up = jnp.logical_not(side0)
            nf = jnp.where(going_up, jnp.float32(n_lo), jnp.float32(n_hi))
            nt = jnp.where(going_up, jnp.float32(n_hi), jnp.float32(n_lo))
            cos_i = jnp.clip(jnp.abs(d[ax]), jnp.float32(0.0),
                             jnp.float32(1.0))
            sin2_i = jnp.float32(1.0) - cos_i * cos_i
            mu = nf / nt
            sin2_t = mu * mu * sin2_i
            tir = sin2_t > 1.0
            cos_t = jnp.sqrt(jnp.clip(jnp.float32(1.0) - sin2_t,
                                      jnp.float32(0.0), jnp.float32(1.0)))
            rs = (nf * cos_i - nt * cos_t) / (nf * cos_i + nt * cos_t)
            rp = (nf * cos_t - nt * cos_i) / (nf * cos_t + nt * cos_i)
            R = jnp.where(tir, jnp.float32(1.0),
                          jnp.clip(jnp.float32(0.5) * (rs * rs + rp * rp),
                                   jnp.float32(0.0), jnp.float32(1.0)))
            u = rng.uniform(shape)
            refl = crossed & (u < R)
            dz = z1 - z0
            s = (loc_f - z0) / jnp.where(crossed, dz, jnp.float32(1.0))
            seg = dr_norm()
            sgn = jnp.where(d[ax] >= 0, jnp.float32(1.0), jnp.float32(-1.0))
            d_tr = [mu * d[dd] for dd in range(3)]
            d_tr[ax] = sgn * cos_t
            inv_tr = jax.lax.rsqrt(jnp.maximum(
                d_tr[0] * d_tr[0] + d_tr[1] * d_tr[1] + d_tr[2] * d_tr[2],
                jnp.float32(1e-30)))
            if match:
                n_out = jnp.where(refl, nf, nt)
                speed_out = jnp.float32(op.c_val) / n_out
            else:
                speed_out = jnp.float32(1.0) / inv_speed
            rem = (jnp.float32(1.0) - s) * seg * speed_out * inv_speed
            for dd in range(3):
                d_out = jnp.where(refl,
                                  -d[dd] if dd == ax else d[dd],
                                  d_tr[dd] * inv_tr)
                r0 = f[_RX + dd] - f[_DRX + dd]
                pdd = r0 + s * f[_DRX + dd]
                r_new = pdd + d_out * rem
                f[_RX + dd] = jnp.where(crossed, r_new, f[_RX + dd])
                f[_DRX + dd] = jnp.where(crossed, r_new - r0, f[_DRX + dd])
                f[_VX + dd] = jnp.where(crossed, d_out * speed_out,
                                        f[_VX + dd])
        elif op.kind == "custom":
            # user elementwise physics (ElementwiseStep contract): the fn
            # sees this tile's planes; updates write back in place. t/dt are
            # the values the GENERIC path would expose at this step's
            # position relative to UpdateTimeStep (sched rows 1-4).
            from physicl_tpu.engine import ParticleView

            names = ParticleView._FIELDS
            plane_of = {n: i for i, n in enumerate(names)}
            view_fields = {n: (alive_b if n == "alive" else f[plane_of[n]])
                           for n in names}
            if t is None:
                t_op, dt_op = jnp.float32(0.0), dt
            else:
                t_op = t[0] if op.after_update else t[1]
                dt_op = t[2] if op.after_update else t[3]
            view = ParticleView(view_fields, t_op, dt_op,
                                lambda: rng.uniform(shape),
                                extras=_view_extras_of(op, f))
            upd = op.custom_fn(view)
            bad = set(upd) - set(names) - set(op.extras_write)
            if bad:  # same validation the generic path gives (trace time)
                raise ValueError(
                    f"ElementwiseStep returned unknown fields {bad} "
                    f"(transport fields or extras_write="
                    f"{op.extras_write} only)")
            extras_at = {nm: (p0, rows) for nm, p0, rows in op.view_extras}
            for name, val in upd.items():
                if name == "alive":
                    alive_b = alive_b & jnp.asarray(val).astype(jnp.bool_)
                    f[_ALIVE] = alive_b.astype(jnp.float32)
                elif name in extras_at:  # declared writable aux plane
                    p0, rows_n = extras_at[name]
                    if rows_n == 1:
                        f[p0] = jnp.asarray(val).astype(jnp.float32)
                    else:
                        comps = tuple(val)
                        if len(comps) != rows_n:  # trace-time, both paths
                            raise ValueError(
                                f"extras_write plane {name!r} has {rows_n} "
                                f"rows; update returned {len(comps)} "
                                "components")
                        for i_ in range(rows_n):
                            f[p0 + i_] = jnp.asarray(
                                comps[i_]).astype(jnp.float32)
                else:
                    f[plane_of[name]] = jnp.asarray(val).astype(jnp.float32)
        elif op.kind == "kstate":
            # user KernelStep(elementwise=True): a per-particle SimState ->
            # SimState map traced over this tile's planes through a facade
            # state (contract in kernels.KernelStep: `a` reads zeros; only
            # the packed transport fields write back; alive can only clear;
            # ctx use was refused at plan time). Shapes are opaque to an
            # elementwise fn, so the facade carries (3, R, 128)/(R, 128)
            # planes where the generic path carries (3, C)/(C,).
            from physicl_tpu.ops.pipeline import _KernelCtxTrip
            from physicl_tpu.state import SimState

            if t is None:
                t_op, dt_op = jnp.float32(0.0), dt
            else:
                t_op = t[0] if op.after_update else t[1]
                dt_op = t[2] if op.after_update else t[3]

            def stk(i0):
                return jnp.stack([f[i0], f[i0 + 1], f[i0 + 2]])

            if plan.species == SPECIES_MIXED:
                otype_t = f[_NF + plan.extras.index("otype")].astype(
                    jnp.int32)
            else:
                otype_t = jnp.full(shape, plan.species, jnp.int32)
            facade = SimState(
                r=stk(_RX), dr=stk(_DRX), v=stk(_VX), dv=stk(_DVX),
                a=jnp.zeros((3,) + shape, jnp.float32),
                E=f[_E], alive=alive_b, otype=otype_t, w=f[_W],
                t=t_op, dt=dt_op, key=jnp.zeros((2,), jnp.uint32))
            out = op.custom_fn(facade, _KernelCtxTrip())
            if not isinstance(out, SimState):  # trace-time, mirrors generic
                raise TypeError(
                    "KernelStep fn must return a SimState, got "
                    f"{type(out).__name__}")
            for d in range(3):
                f[_RX + d] = out.r[d].astype(jnp.float32)
                f[_DRX + d] = out.dr[d].astype(jnp.float32)
                f[_VX + d] = out.v[d].astype(jnp.float32)
                f[_DVX + d] = out.dv[d].astype(jnp.float32)
            f[_E] = out.E.astype(jnp.float32)
            f[_W] = out.w.astype(jnp.float32)
            alive_b = alive_b & out.alive.astype(jnp.bool_)
            f[_ALIVE] = alive_b.astype(jnp.float32)
        elif op.kind == "reduce":
            # user per-particle measurement (engine.ReduceMeasureStep):
            # evaluate the contributions on this tile and sum the alive ones
            # into float record channels — tile sums add across the grid
            # (and psum across shards) into the global per-iteration totals
            from physicl_tpu.engine import ParticleView

            names = ParticleView._FIELDS
            plane_of = {n: i for i, n in enumerate(names)}
            view_fields = {n: (alive_b if n == "alive" else f[plane_of[n]])
                           for n in names}
            if t is None:
                t_op, dt_op = jnp.float32(0.0), dt
            else:
                t_op = t[0] if op.after_update else t[1]
                dt_op = t[2] if op.after_update else t[3]
            view = ParticleView(view_fields, t_op, dt_op,
                                lambda: rng.uniform(shape),
                                extras=_view_extras_of(op, f))
            contrib = op.custom_fn(view)
            missing = set(op.reduce_outputs) - set(contrib)
            if missing:  # same validation as the generic path (trace time)
                raise ValueError(
                    f"ReduceMeasureStep fn did not return declared outputs "
                    f"{sorted(missing)}")
            n_col, f0 = op.cols
            if n_col >= 0:
                row = put(row, n_col, jnp.sum(alive_b, dtype=jnp.int32))
            for j, name in enumerate(op.reduce_outputs):
                val = jnp.asarray(contrib[name]).astype(jnp.float32)
                row_f = put_f(row_f, f0 + j,
                              jnp.sum(jnp.where(alive_b, val,
                                                jnp.float32(0.0))))
        elif op.kind == "trace":
            # per-photon positions at this step's position in the pipeline;
            # dead/padding slots encode as NaN (the reference row format's
            # NaN padding after death, physicl/light.py:463-483)
            for d in range(3):
                stream[op.stream0 + d] = jnp.where(alive_b, f[_RX + d], _nan)
            if op.stream_scat:  # scatter-event flags for trace_dv frequency
                scat = ((f[_DVX] != 0) | (f[_DVY] != 0)
                        | (f[_DVZ] != 0)) & alive_b
                stream[op.stream0 + 3] = scat.astype(jnp.float32)
        elif op.kind == "sign":
            n_col, sx_col = op.cols
            if n_col >= 0:
                row = put(row, n_col, jnp.sum(alive_b, dtype=jnp.int32))
            for d in range(3):
                pos = (f[_VX + d] > 0) & alive_b
                if op.weighted:  # Sigma w over positive-velocity photons
                    row_f = put_f(row_f, sx_col + d,
                                  jnp.sum(jnp.where(pos, f[_W], 0.0)))
                else:
                    row = put(row, sx_col + d, jnp.sum(pos, dtype=jnp.int32))
        elif op.kind == "sabsorb":
            # absorbing sphere (newton.AbsorbingSphereStep): kill leavers
            # (escape sphere) or entrants (central absorber, inside=True)
            cx, cy, cz, R = (jnp.float32(x) for x in op.sphere)
            dx0, dy0, dz0 = f[_RX] - cx, f[_RY] - cy, f[_RZ] - cz
            r2 = dx0 * dx0 + dy0 * dy0 + dz0 * dz0
            in_s = r2 <= R * R
            alive_b = alive_b & (jnp.logical_not(in_s) if op.inside
                                 else in_s)
            f[_ALIVE] = alive_b.astype(jnp.float32)
        elif op.kind == "scross":
            # spherical-shell flux tally (light.SphericalShellMeasureStep):
            # the plane tally's endpoint convention on |r - c| vs R
            n_col, col = op.cols
            if n_col >= 0:
                row = put(row, n_col, jnp.sum(alive_b, dtype=jnp.int32))
            cx, cy, cz, R = (jnp.float32(x) for x in op.sphere)
            dx1, dy1, dz1 = f[_RX] - cx, f[_RY] - cy, f[_RZ] - cz
            dx0 = dx1 - f[_DRX]
            dy0 = dy1 - f[_DRY]
            dz0 = dz1 - f[_DRZ]
            r1 = dx1 * dx1 + dy1 * dy1 + dz1 * dz1
            r0 = dx0 * dx0 + dy0 * dy0 + dz0 * dz0
            R2 = R * R
            crossed = (((r0 <= R2) & (R2 <= r1))
                       | ((r0 >= R2) & (R2 >= r1))) & alive_b
            if op.weighted:
                row_f = put_f(row_f, col,
                              jnp.sum(jnp.where(crossed, f[_W], 0.0)))
            else:
                row = put(row, col, jnp.sum(crossed, dtype=jnp.int32))
        elif op.kind == "cross":
            (n_col,) = op.cols
            if n_col >= 0:
                row = put(row, n_col, jnp.sum(alive_b, dtype=jnp.int32))
            for axis, L, col, e_col, ecap in op.axes:
                hi = f[_RX + axis]
                lo = hi - f[_DRX + axis]
                Lv = jnp.float32(L)
                crossed = (((lo <= Lv) & (Lv <= hi))
                           | ((lo >= Lv) & (Lv >= hi))) & alive_b
                if op.weighted:  # surface current: Sigma w over crossers
                    row_f = put_f(row_f, col,
                                  jnp.sum(jnp.where(crossed, f[_W], 0.0)))
                else:
                    row = put(row, col, jnp.sum(crossed, dtype=jnp.int32))
                if e_col >= 0:  # energy flux: sum of crossing photons' E
                    flux = f[_W] * f[_E] if op.weighted else f[_E]
                    row_f = put_f(row_f, e_col,
                                  jnp.sum(jnp.where(crossed, flux, 0.0)))
                if ecap >= 0:  # per-photon E capture (reference list mode,
                    # physicl/light.py:388-402): E where crossed, NaN else
                    stream[ecap] = jnp.where(crossed, f[_E], _nan)

    # col 0: global alive count at iteration end (predicate/trim channel)
    row = put(row, 0, jnp.sum(alive_b, dtype=jnp.int32))
    return f, row, row_f, stream


def _sched_at(dts, k):
    """Iteration ``k``'s schedule: (dt at kinematics, (t after update, t
    before update, dt after update, dt before update))."""
    return dts[0, k], (dts[1, k], dts[2, k], dts[3, k], dts[4, k])


def _dense_row(tallies: dict, dtype):
    """``{column: scalar}`` tallies -> one (128,) record row."""
    row = jnp.zeros((_MAX_REC_COLS,), dtype)
    for col, val in tallies.items():
        row = row.at[col].set(val)
    return row


def _stream_geometry(plan: FusedPlan):
    """(stream stride, stream rows per chunk, stream dtype)."""
    s_every = max(1, int(plan.stream_every))
    sdtype = (jnp.bfloat16 if plan.stream_dtype == "bfloat16"
              else jnp.float32)
    return s_every, -(-plan.chunk // s_every), sdtype


def _build_xla_chunk(plan: FusedPlan, capacity: int):
    """The op body in a ``lax.fori_loop`` over the whole population as one
    tile, compiled by XLA: the plain reference for the Triton kernel, the
    CPU path, and the GPU path for plans the kernel does not take.

    Identical physics, record layout and random bits as the kernel. This is
    also what the multi-device dry run exercises under shard_map on virtual
    CPU devices.
    """
    rows = capacity // _LANE
    nf = _NF + len(plan.extras)
    s_every, n_srows, sdtype = _stream_geometry(plan)

    @jax.jit
    def run(packed, dts, emit_starts, seed, k_act):
        dts = jnp.asarray(dts, jnp.float32)
        emit_starts = jnp.asarray(emit_starts, jnp.int32)
        seed = jnp.asarray(seed, jnp.int32)
        fields = [packed[i].reshape(rows, _LANE) for i in range(nf)]
        rec0 = jnp.zeros((plan.chunk, _MAX_REC_COLS), jnp.int32)
        recf0 = jnp.zeros((plan.chunk, _MAX_REC_COLS), jnp.float32)
        stream0 = jnp.full((n_srows, plan.n_stream, rows, _LANE), jnp.nan,
                           sdtype)
        gidx = (jax.lax.broadcasted_iota(jnp.int32, (rows, _LANE), 0)
                * jnp.int32(_LANE)
                + jax.lax.broadcasted_iota(jnp.int32, (rows, _LANE), 1))

        def body(k, carry):
            fields, rec, rec_f, stream_buf = carry
            dt, t = _sched_at(dts, k)
            fields, row, row_f, stream = _emit_iteration(
                plan, k, dt, fields, _Rng(seed, k), emit_starts, gidx, t=t)
            if plan.n_stream:
                m = k // s_every
                val = jnp.stack(stream).astype(sdtype)
                if s_every > 1:  # keep row m untouched off sample iterations
                    val = jnp.where(jax.lax.rem(k, s_every) == 0, val,
                                    stream_buf[m])
                stream_buf = stream_buf.at[m].set(val)
            return (fields, rec.at[k].add(_dense_row(row, jnp.int32)),
                    rec_f.at[k].add(_dense_row(row_f, jnp.float32)),
                    stream_buf)

        fields, rec, rec_f, stream_buf = jax.lax.fori_loop(
            0, jnp.asarray(k_act, jnp.int32), body,
            (fields, rec0, recf0, stream0))
        out = jnp.stack([f.reshape(capacity) for f in fields])
        if plan.n_stream:
            return (out, rec, rec_f,
                    stream_buf.reshape(n_srows, plan.n_stream, capacity))
        return out, rec, rec_f

    return run


# Record accumulators the kernel's programs spread their atomics over
# (program p adds into copy p % _REC_SPREAD); XLA sums the copies. Every
# program tallies every iteration, so one copy would put all of them on the
# same few addresses.
_REC_SPREAD = 16


def _triton_kernel(plan: FusedPlan, tile_rows: int, n_tables: int,
                   ctl_ref, dts_ref, emit_ref, state_ref, *refs):
    """One program: a (tile_rows, 128) block of photons, held in registers
    for all ``k_act`` iterations of the chunk. Inputs are whole-array refs;
    the state input aliases the state output, and the zeroed record
    accumulators (and the NaN stream buffer) alias theirs."""
    from jax.experimental.pallas import triton as plgpu

    tables = refs[:n_tables]
    n_alias = 2 + (1 if plan.n_stream else 0)
    out_ref, rec_ref, recf_ref = refs[n_tables + n_alias:
                                      n_tables + n_alias + 3]
    stream_ref = refs[n_tables + n_alias + 3] if plan.n_stream else None
    if n_tables:
        # rebind voxel-media fields to direct gathers from their table
        # refs: op.n_fn keeps the universal (r0, r1, r2) calling convention
        slots, _ = _vox_specs_of(plan)
        ops = [op if slot < 0 else dataclasses.replace(
                   op, n_fn=_bind_vox_field(op.n_fn.vox_spec, tables[slot]))
               for op, slot in zip(plan.ops, slots)]
        plan = dataclasses.replace(plan, ops=ops)
    nf = _NF + len(plan.extras)
    pid = pl.program_id(0)
    row0 = pid * jnp.int32(tile_rows)
    rows = pl.ds(row0, tile_rows)
    seed = ctl_ref[0]
    k_act = ctl_ref[1]
    slot = jax.lax.rem(pid, jnp.int32(_REC_SPREAD))
    s_every, _, _ = _stream_geometry(plan)
    gidx = (row0 * jnp.int32(_LANE)
            + jax.lax.broadcasted_iota(jnp.int32, (tile_rows, _LANE), 0)
            * jnp.int32(_LANE)
            + jax.lax.broadcasted_iota(jnp.int32, (tile_rows, _LANE), 1))

    def one_iter(k, fields):
        dt, t = _sched_at(dts_ref, k)
        fields, row, row_f, stream = _emit_iteration(
            plan, k, dt, list(fields), _Rng(seed, k, row0), emit_ref, gidx,
            t=t)
        for col, val in row.items():
            plgpu.atomic_add(rec_ref, (slot, k, col), val)
        for col, val in row_f.items():
            plgpu.atomic_add(recf_ref, (slot, k, col), val)
        if plan.n_stream:
            def store(m):
                for p, plane in enumerate(stream):
                    stream_ref[m, p, rows, :] = plane.astype(stream_ref.dtype)

            if s_every == 1:
                store(k)
            else:
                pl.when(jax.lax.rem(k, jnp.int32(s_every)) == 0)(
                    lambda: store(k // jnp.int32(s_every)))
        return tuple(fields)

    fields = tuple(state_ref[i, rows, :] for i in range(nf))
    fields = jax.lax.fori_loop(0, k_act, one_iter, fields)
    for i in range(nf):
        out_ref[i, rows, :] = fields[i]


def _build_triton_chunk(plan: FusedPlan, capacity: int,
                        interpret: bool = False):
    """The chunk as a Pallas kernel on the Triton route: one program per
    (tile_rows, 128) block. ``interpret=True`` runs it through the Pallas
    interpreter, which only the CPU tests use."""
    from jax.experimental.pallas import triton as plgpu

    if interpret and jax.default_backend() != "cpu":
        raise ValueError("interpret mode is a CPU test tool")
    rows = capacity // _LANE
    nf = _NF + len(plan.extras)
    tile_rows = plan.tile_rows
    while rows % tile_rows:
        tile_rows //= 2
    _, n_srows, sdtype = _stream_geometry(plan)
    _, vox_specs = _vox_specs_of(plan)
    tables = [_vox_table_of(spec) for spec in vox_specs]
    rec_shape = (_REC_SPREAD, plan.chunk, _MAX_REC_COLS)
    out_shape = [jax.ShapeDtypeStruct((nf, rows, _LANE), jnp.float32),
                 jax.ShapeDtypeStruct(rec_shape, jnp.int32),
                 jax.ShapeDtypeStruct(rec_shape, jnp.float32)]
    stream_shape = (n_srows, plan.n_stream, rows, _LANE)
    if plan.n_stream:
        out_shape.append(jax.ShapeDtypeStruct(stream_shape, sdtype))
    # operands: ctl, dts, emit, state, *tables, rec0, recf0(, stream0)
    n_in = 4 + len(tables)
    aliases = {3: 0, n_in: 1, n_in + 1: 2}
    if plan.n_stream:
        aliases[n_in + 2] = 3
    call = pl.pallas_call(
        partial(_triton_kernel, plan, tile_rows, len(tables)),
        grid=(rows // tile_rows,),
        out_shape=out_shape,
        input_output_aliases=aliases,
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=plan.num_warps,
                                             num_stages=1),
        name="physicl_fused_chunk",
    )

    @jax.jit
    def run(packed, dts, emit_starts, seed, k_act):
        ctl = jnp.stack([jnp.asarray(seed, jnp.int32),
                         jnp.asarray(k_act, jnp.int32)])
        args = [ctl, jnp.asarray(dts, jnp.float32),
                jnp.asarray(emit_starts, jnp.int32),
                packed.reshape(nf, rows, _LANE), *tables,
                jnp.zeros(rec_shape, jnp.int32),
                jnp.zeros(rec_shape, jnp.float32)]
        if plan.n_stream:
            args.append(jnp.full(stream_shape, jnp.nan, sdtype))
        res = call(*args)
        out = (res[0].reshape(nf, capacity), res[1].sum(0), res[2].sum(0))
        if plan.n_stream:
            return out + (res[3].reshape(n_srows, plan.n_stream, capacity),)
        return out

    return run


# Arrays up to this many bytes are keyed by a full content hash; larger
# ones by identity (anchored — see _freeze).  4 MB hashes in ~1 ms, and
# constants folded into kernels beyond that are a perf smell anyway.
_HASH_NBYTES_MAX = 4 << 20


def _freeze(v, anchors, depth=0):
    """Hashable snapshot of a value for cache keying. Scalars/strings by
    value; containers recursively (depth-capped); numpy arrays by content
    (raw bytes when tiny, SHA-1 up to ``_HASH_NBYTES_MAX``). Anything
    keyed by identity — device arrays (immutable, so id is a sound
    content proxy while the object is alive), huge numpy arrays,
    arbitrary objects — is appended to ``anchors``: the cache entry holds
    those references so a freed object's id can never be recycled into a
    stale hit. In-place mutation of a >4 MB numpy array is the one
    undetectable case (documented with the globals hazard in
    :func:`clear_kernel_cache`)."""
    if depth > 3:
        return type(v).__name__
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_freeze(x, anchors, depth + 1) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(
            (str(k), _freeze(x, anchors, depth + 1)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        if v.size <= 256:
            return (v.dtype.str, v.shape, v.tobytes())
        if v.nbytes <= _HASH_NBYTES_MAX:
            import hashlib

            return (v.dtype.str, v.shape,
                    hashlib.sha1(np.ascontiguousarray(v).tobytes()).digest())
        anchors.append(v)
        return ("np-id", id(v), v.dtype.str, v.shape)
    anchors.append(v)
    return ("id", id(v))


def _fn_key(fn, anchors):
    """Identity key for a plan callable. Kernels get user callables folded
    in as traced constants, so the key must change whenever the values the
    callable would produce could change — not just when the function object
    does. Bound methods are keyed by (receiver class, receiver state
    snapshot, function): mutating ``sampler.T = ...`` on a reused
    PlanckSampler then misses the cache and re-traces with the new
    temperature, and a subclass overriding a helper the method calls gets
    its own entry (same inherited ``__code__``, different class). Plain
    functions are keyed by (code identity, defaults, closure-cell
    snapshot) so a closure over a changed local re-traces too. Mutated
    *globals* read inside the callable are not detectable — call
    :func:`clear_kernel_cache` after changing one (documented in
    docs/api.md). Objects keyed by id are appended to ``anchors`` (kept
    alive by the cache entry) so id recycling cannot alias keys."""
    if fn is None:
        return None
    recv = getattr(fn, "__self__", None)
    if recv is not None:
        f = getattr(fn, "__func__", fn)
        try:
            state = _freeze(vars(recv), anchors)
        except TypeError:  # __slots__ / C receivers: fall back to identity
            anchors.append(recv)
            state = id(recv)
        cls = type(recv)
        anchors.append(cls)
        code = getattr(f, "__code__", f)
        anchors.append(code)
        return (f.__qualname__, id(code), cls.__qualname__, id(cls), state)
    code = getattr(fn, "__code__", None)
    if code is None:  # builtins / partials / arbitrary callables
        anchors.append(fn)
        return id(fn)
    anchors.append(code)
    cells = tuple(_freeze(c.cell_contents, anchors)
                  for c in (fn.__closure__ or ()) if _cell_filled(c))
    return (id(code), _freeze(fn.__defaults__, anchors), cells)


def _cell_filled(cell):
    try:
        cell.cell_contents
        return True
    except ValueError:  # unfilled cell (recursive def)
        return False


def clear_kernel_cache():
    """Drop every cached compiled fused chunk.

    The cache keys user callables by a best-effort state snapshot
    (receiver attributes, closure cells); it cannot see mutations to
    module globals a callable reads. Call this after such a mutation to
    force a re-trace with the new values."""
    _chunk_cache.clear()


_OP_FN_FIELDS = frozenset({"custom_fn", "n_fn", "a_fn", "emit_E_fn",
                           "e_fn", "b_fn"})


def _plan_cache_key(plan: FusedPlan, capacity: int):
    """(structural identity of a compiled chunk, id-anchored objects).

    Derived from ``dataclasses.fields`` so a field added to ``_Op`` or
    ``FusedPlan`` is part of the key automatically — an explicit tuple here
    silently served stale kernels when a new op parameter was introduced
    (the exact hazard ADVICE r2 #1 flagged for callable state)."""
    anchors: list = []
    ops = tuple(
        tuple(_fn_key(getattr(op, f.name), anchors)
              if f.name in _OP_FN_FIELDS else getattr(op, f.name)
              for f in dataclasses.fields(op))
        for op in plan.ops)
    plan_rest = tuple(getattr(plan, f.name) for f in dataclasses.fields(plan)
                      if f.name != "ops")
    return (capacity, ops) + plan_rest, anchors


# key -> (plan, compiled runner, anchors); FIFO-bounded.  ``anchors`` pins
# every object the key references by id() so that id cannot be recycled
# by a new object while the entry is live (stale-hit hazard otherwise).
_chunk_cache: dict = {}
_CHUNK_CACHE_MAX = 64


def build_fused_chunk(plan: FusedPlan, capacity: int):
    """Compile the fused chunk: (packed_state, dts, seed, k_act) -> (state, rec).

    ``packed_state`` is (15, C) f32; rec is (chunk, 128) int32 with col 0 the
    global alive count per iteration and measure channels per the plan.

    Structurally identical (plan, capacity) pairs return the SAME jitted
    runner: repeated sims (sweeps, notebooks, tests) and same-capacity
    provider invalidations (slot recycling, mid-run edits) skip the
    re-trace + compile round trip entirely.
    """
    key, anchors = _plan_cache_key(plan, capacity)
    hit = _chunk_cache.get(key)
    if hit is not None:
        return hit[1]
    # lazily, right before the first real compile — constructing a
    # Simulation must not mutate process-global JAX config (advisor finding)
    from physicl_tpu.utils.cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    run = _build_fused_chunk_uncached(plan, capacity)
    if len(_chunk_cache) >= _CHUNK_CACHE_MAX:  # FIFO: drop the oldest
        _chunk_cache.pop(next(iter(_chunk_cache)))
    _chunk_cache[key] = (plan, run, anchors)
    return run


def _build_fused_chunk_uncached(plan: FusedPlan, capacity: int):
    if plan.builder == "triton":
        return _build_triton_chunk(plan, capacity)
    return _build_xla_chunk(plan, capacity)


# Triton kernel launch shape: photons per program = tile_rows * 128, here
# two per thread over FusedPlan.num_warps = 2 warps. One row over two warps
# was fastest or within 15% of the fastest of nine shapes for the
# isotropic, Compton and polarized bodies on an H100 (docs/performance.md);
# a 2x inner unroll of the iteration loop measured no gain and was dropped.
KERNEL_TILE_ROWS = 1

# Plans tallying more record columns than this run on the XLA chunk: every
# program reduces and adds each column every iteration. Measured on an H100
# (benchmarks/routing.py): behind the isotropic body the kernel ran 1.75x
# the XLA chunk at 16 columns and 10^6 photons but 0.78x at 20 columns and
# 10^7; behind thermal Compton it still won at 36 columns and lost at 60.
# The cut protects the light bodies at the headline population. On these
# spectrum plans the XLA chunk beat the generic scan at every width.
KERNEL_MAX_REC_COLS = 16

def _record_columns(plan: FusedPlan) -> int:
    """Record columns the plan tallies per iteration (int + float)."""
    n_emit = max(1, sum(op.kind == "emit" for op in plan.ops))
    tallies = jax.eval_shape(
        lambda f: _emit_iteration(plan, jnp.int32(0), jnp.float32(0.0),
                                  list(f), _Rng(jnp.int32(0), jnp.int32(0)),
                                  jnp.zeros((n_emit, plan.chunk), jnp.int32),
                                  jnp.zeros((1, _LANE), jnp.int32),
                                  t=(jnp.float32(0.0),) * 4)[1:3],
        [jax.ShapeDtypeStruct((1, _LANE), jnp.float32)]
        * (_NF + len(plan.extras)))
    return len(tallies[0]) + len(tallies[1])


def kernel_lowers(plan: FusedPlan) -> Optional[str]:
    """Why the Triton route cannot lower this plan, or None.

    Lowers the kernel for CUDA at one block's capacity, user callables
    included. Lowering runs on the host and needs no card; what it refuses
    (an op without a Triton rule, a concatenate of more than two operands)
    the first dispatch would refuse too."""
    cap = plan.tile_rows * _LANE
    n_emit = max(1, sum(op.kind == "emit" for op in plan.ops))
    try:
        jax.jit(_build_triton_chunk(plan, cap)).trace(
            jax.ShapeDtypeStruct((_NF + len(plan.extras), cap), jnp.float32),
            jax.ShapeDtypeStruct((5, plan.chunk), jnp.float32),
            jax.ShapeDtypeStruct((n_emit, plan.chunk), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32),
        ).lower(lowering_platforms=("cuda",))
    except Exception as e:  # the reason goes to explain_plan()
        msg = str(e).strip().splitlines()
        return ("the Triton route cannot lower the kernel: "
                f"{type(e).__name__}: {msg[0].rstrip('.') if msg else ''}. "
                "At small populations fuse='off' may be faster: on an H100 "
                "the element-wise KernelStep plan ran on the XLA chunk at "
                "0.87x the generic scan's rate at 10^6 photons, 1.15x at "
                "10^7")
    return None


_blocker_cache: dict = {}


def triton_blockers(plan: FusedPlan) -> Optional[str]:
    """Why the planner keeps this plan off the Triton kernel, or None: it
    cannot lower, or it tallies more record columns than pay on the
    kernel. Memoized per plan structure (the check traces the kernel)."""
    key, anchors = _plan_cache_key(plan, 0)
    if key not in _blocker_cache:
        why = kernel_lowers(plan)
        if why is None:
            n = _record_columns(plan)
            if n > KERNEL_MAX_REC_COLS:
                why = (f"{n} record columns per iteration; past "
                       f"{KERNEL_MAX_REC_COLS} the kernel's per-column "
                       "reductions can cost more than the XLA chunk's")
        if len(_blocker_cache) >= _CHUNK_CACHE_MAX:  # FIFO: drop the oldest
            _blocker_cache.pop(next(iter(_blocker_cache)))
        _blocker_cache[key] = (why, anchors)
    return _blocker_cache[key][0]


def choose_builder(plan: FusedPlan, backend: Optional[str] = None) -> tuple:
    """``(builder, reason)`` for this plan: the Triton kernel on the GPU
    where it can take the plan, the XLA chunk everywhere else. A static
    choice, made once per plan; nothing falls back at dispatch."""
    backend = backend or jax.default_backend()
    if backend != "gpu":
        return "xla", (f"the {backend} backend runs the XLA chunk; the "
                       "Triton kernel is compiled for GPUs only")
    why = triton_blockers(plan)
    if why is not None:
        return "xla", why
    return "triton", ("Pallas kernel on the Triton route: "
                      f"{plan.tile_rows * _LANE} photons per program held in "
                      f"registers for the chunk, {plan.num_warps} warps")


def pack_state(state: SimState, extras: tuple = ()) -> jax.Array:
    """SimState -> packed (15 + len(extras), C) f32 (one concat; slices come
    back out). ``extras`` names resolve against ``state.extras``; the derived
    pseudo-plane ``"qm"`` packs the charge-to-mass ratio ``q / m`` (0 where
    ``m == 0`` — uncharged/unset particles are never pushed, matching
    newton.LorentzForceStep's generic-path guard); ``"name:i"`` packs row
    ``i`` of a multi-row extras array (e.g. ``"stokes:1"`` -> the U Stokes
    component plane)."""
    planes = [state.r, state.dr, state.v, state.dv,
              state.E[None].astype(jnp.float32),
              state.alive[None].astype(jnp.float32),
              state.w[None].astype(jnp.float32)]
    for name in extras:
        if name == "qm":
            q = state.extras["q"].astype(jnp.float32)
            m = state.extras["m"].astype(jnp.float32)
            safe = jnp.where(m != 0, m, jnp.ones_like(m))
            planes.append(jnp.where(m != 0, q / safe, 0.0)[None])
        elif name == "otype":  # mixed-species plans: per-particle type gate
            planes.append(state.otype.astype(jnp.float32)[None])
        elif ":" in name:      # row of a multi-row extras array
            base, idx = name.rsplit(":", 1)
            planes.append(
                state.extras[base][int(idx)].astype(jnp.float32)[None])
        else:
            planes.append(state.extras[name].astype(jnp.float32)[None])
    return jnp.concatenate(planes, axis=0)


def unpack_state(packed: jax.Array, template: SimState,
                 extras: tuple = (), writeback: tuple = ()) -> SimState:
    """Packed (NF, C) -> SimState. ``writeback`` lists extras BASE names the
    kernel mutated (FusedPlan.extras_writeback): their planes are gathered
    from the packed array (rows ordered by the ``name:i`` suffix) and
    replace the corresponding ``template.extras`` entries; all other extras
    stay host-authoritative."""
    state = template.replace(
        r=packed[_RX:_RX + 3], dr=packed[_DRX:_DRX + 3],
        v=packed[_VX:_VX + 3], dv=packed[_DVX:_DVX + 3],
        E=packed[_E].astype(template.E.dtype),
        alive=packed[_ALIVE] > 0,
        w=packed[_W].astype(template.w.dtype),
    )
    if writeback:
        new_extras = dict(template.extras)
        for base in writeback:
            rows = sorted(
                (int(n.rsplit(":", 1)[1]), j)
                for j, n in enumerate(extras) if n.startswith(base + ":"))
            tmpl = template.extras[base]
            if rows:
                new_extras[base] = jnp.stack(
                    [packed[_NF + j] for _, j in rows]).astype(tmpl.dtype)
            else:  # single-plane extras packed under the bare name
                new_extras[base] = packed[
                    _NF + extras.index(base)].astype(tmpl.dtype)
        state = state.replace(extras=new_extras)
    return state
