"""Fused-pipeline provider: proves a step list fusable, then serves engine
chunks from the multi-iteration fused chunk in :mod:`physicl_tpu.ops.fused`
(the Triton kernel on GPUs, the XLA chunk elsewhere; ``choose_builder``).

Fusability requirements (everything else falls back to the generic scan):

* steps are exactly: one ``UpdateTimeStep`` whose dt function depends on at
  most ``(t, dt)``, plus any mix of ``NewtonianKinematicsStep``,
  ``ScatterDeleteStep``, ``ScatterIsotropicStep``,
  ``ScatterHenyeyGreensteinStep``, ``ScatterRayleighStep``,
  ``ScatterPhaseFunctionStep``, ``ScatterComptonStep``,
  ``AbsorbingBoundaryStep``, ``ReflectingBoundaryStep``,
  ``PhotonEmitterStep``, ``ElementwiseStep`` (including writable
  ``extras_write=`` aux planes), ``KernelStep(elementwise=True)``,
  ``ReduceMeasureStep``, ``TracePathMeasureStep``,
  ``ScatterSignMeasureStep`` and ``ScatterMeasureStep``; field callables
  may be ``light.voxel_density`` grids up to the fused voxel caps;
* the population is photons, charged/generic particles (``LorentzForceStep``
  — species-wide or per-particle q/m via a packed extras plane), or a MIX of
  both (a packed otype plane gates photon physics per particle); only a pure
  non-photon population with photon-only steps stays generic;
* the exit predicate is either *t-only* (the exact exit iteration is
  precomputed on the host by replaying the f32 time arithmetic) or
  *extinction* (``n_objects == 0`` — verified empirically on sample host
  views; safe to overshoot because iterations on an all-dead population are
  physical no-ops, and records are trimmed to the exact exit point).

The provider implements the engine's chunk contract
``state -> (state, done, records, valid)`` so measurement collection,
``sim.ts`` and CSV output are byte-identical between paths.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.state import OBJ_PHOTON, SimState
from physicl_tpu.units import Measurement, raw_code_value
from physicl_tpu.ops import fused as F

__all__ = ["try_build_fused", "FusedProvider"]

_EMIT_INACTIVE = -(2 ** 30)  # far-negative start: window never overlaps


class _TOnly:
    """Host probe view exposing only t/dt; touching anything else raises."""

    def __init__(self, t, dt):
        self.t = t
        self.dt = dt

    def __getattr__(self, name):  # n_objects, objects, bounds, ...
        raise AttributeError(name)


def _probe_t_only(fn) -> bool:
    try:
        for t in (0.0, 1.0, 1e30):
            fn(_TOnly(np.float32(t), np.float32(1e-3)))
        return True
    except Exception:
        return False


class _TN:
    def __init__(self, t, n):
        self.t = t
        self.dt = np.float32(1e-3)
        self.n_objects = n
        self.objects = _Len(n)


class _Len:
    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n


def _probe_extinction(fn) -> bool:
    """True iff fn behaves as 'no objects left' on sampled host views:
    True whenever n == 0, False whenever n > 0, regardless of t."""
    try:
        for t in (0.0, 1e-3, 1e30):
            if not bool(fn(_TN(np.float32(t), 0))):
                return False
            for n in (1, 2, 17, 10_000_000):
                if bool(fn(_TN(np.float32(t), n))):
                    return False
        return True
    except Exception:
        return False


def _as_f(x):
    return float(raw_code_value(x)) if isinstance(x, Measurement) else float(x)


class _KernelCtxUse(Exception):
    """A KernelStep(elementwise=True) fn touched its ctx during the plan-
    time probe — the attribute name says which capability it needs."""


class _KernelCtxTrip:
    """ctx stand-in for fused KernelStep fns: every attribute access
    raises. At plan time the probe converts that into a structured
    refusal; in-kernel it can only fire if the fn behaves differently
    under tracing than it did in the probe (same exception, trace time)."""

    def __getattr__(self, name):
        raise _KernelCtxUse(name)


class _KernelStateUse(Exception):
    """A probed fn touched a poisoned state field (``a``/``extras``) whose
    in-kernel facade diverges from the generic path (r4 ADVICE finding)."""


def _trip_raise(self, *a, **k):
    raise _KernelStateUse(object.__getattribute__(self, "_name"))


class _TripLeaf:
    """Zero-leaf pytree poison for a SimState field the fused facade cannot
    honor (``a`` reads zeros in-kernel but real values on the generic path):
    any read — arithmetic, indexing, conversion, attribute — raises
    :class:`_KernelStateUse` so the probe refuses with a structured reason
    instead of letting the paths silently diverge."""

    def __init__(self, name):
        object.__setattr__(self, "_name", name)

    def __getattr__(self, attr):
        raise _KernelStateUse(object.__getattribute__(self, "_name"))

    def __eq__(self, other):
        # treedef/aux equality must keep working: JAX compares cached
        # treedef metadata against arbitrary aux objects, so only numeric/
        # array comparands (a user fn's `state.a == 0`) trip the poison
        if isinstance(other, _TripLeaf):
            return (object.__getattribute__(self, "_name")
                    == object.__getattribute__(other, "_name"))
        if isinstance(other, (int, float, complex, np.ndarray, jax.Array)):
            raise _KernelStateUse(object.__getattribute__(self, "_name"))
        return NotImplemented

    def __hash__(self):
        return hash(object.__getattribute__(self, "_name"))


for _dunder in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                "__rfloordiv__", "__mod__", "__rmod__", "__pow__",
                "__rpow__", "__matmul__", "__rmatmul__", "__neg__",
                "__pos__", "__abs__", "__lt__", "__le__", "__gt__",
                "__ge__", "__getitem__", "__iter__", "__len__",
                "__bool__", "__float__", "__int__", "__index__",
                "__array__", "__and__", "__rand__", "__or__", "__ror__",
                "__xor__", "__rxor__", "__invert__"):
    setattr(_TripLeaf, _dunder, _trip_raise)
del _dunder

jax.tree_util.register_pytree_node(
    _TripLeaf, lambda x: ((), x), lambda aux, _: aux)


class _TripExtras:
    """Zero-leaf pytree poison for ``state.extras``: the fused facade
    carries no extras dict, so reads must refuse at plan time (and a
    replaced extras dict on the returned state — ignored in-kernel,
    applied on the generic path — is detected by identity)."""

    def __eq__(self, other):
        return isinstance(other, _TripExtras)

    def __hash__(self):
        return 0


for _m in ("__getitem__", "get", "keys", "values", "items", "__iter__",
           "__len__", "__contains__", "__bool__"):
    setattr(_TripExtras, _m, lambda self, *a, **k: (_ for _ in ()).throw(
        _KernelStateUse("extras")))
del _m

jax.tree_util.register_pytree_node(
    _TripExtras, lambda x: ((), x), lambda aux, _: aux)


def _poisoned_concrete_state(cap: int, seed: int):
    """Concrete CPU SimState for the behavioral probes: real random
    transport planes, poisoned ``a``/``extras``/``key``, exact-f32 t/dt."""
    from physicl_tpu.state import SimState

    rng = np.random.default_rng(seed)

    def mk3():
        return jnp.asarray(rng.standard_normal((3, cap)), jnp.float32)

    return SimState(
        r=mk3(), dr=mk3(), v=mk3(), dv=mk3(), a=_TripLeaf("a"),
        E=jnp.asarray(rng.random(cap) + 0.5, jnp.float32),
        alive=jnp.asarray(rng.random(cap) < 0.8),
        otype=jnp.zeros((cap,), jnp.int32),
        w=jnp.asarray(rng.random(cap) + 0.5, jnp.float32),
        t=jnp.float32(0.8125), dt=jnp.float32(0.0625),
        key=None, extras=_TripExtras())


def _rows_equal(a, b, rows=None):
    """Bitwise (NaN == NaN) equality of two per-particle outputs, optionally
    restricted to a row selection along the last axis."""
    a, b = np.asarray(a), np.asarray(b)
    if rows is not None:
        a, b = a[..., rows], b[..., rows]
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        return bool(np.array_equal(a, b, equal_nan=True))
    return bool(np.array_equal(a, b))


_KSTATE_WB = ("r", "dr", "v", "dv", "E", "alive", "w")


def _probe_kernelstep(fn, sim):
    """None if ``fn`` honors the fused facade contract, else a
    (reason-slug, detail) pair for the structured refusal.

    Phase 1 — abstract (``jax.eval_shape``, no FLOPs): ``state.key`` is
    poisoned to None (the in-kernel facade has no PRNG key; key-derived
    randomness would silently freeze — r4 code-review finding), and
    ``state.a``/``state.extras`` are poisoned with trip objects (``a``
    reads zeros in-kernel but real values on the generic path; extras are
    absent in-kernel — r4 ADVICE finding), so any use refuses to the
    generic scan. Writes to ``a``/``extras``/``t``/``dt``, which the
    kernel ignores but the generic path applies, are detected by trip-
    identity / bitwise-equality on the returned state.

    Phase 2 — concrete (tiny CPU evaluation, r4 VERDICT item): the
    ``elementwise=True`` claim itself is now verified behaviorally —
    a row-permuted input must produce the identically-permuted output
    (catches gathers/shifts/index-dependence), perturbing ONE particle
    must not change any other particle's outputs (catches reductions,
    which are permutation-invariant), and doubling the capacity must not
    change per-row results (catches 1/N-style normalizations). A fn that
    gathers or reduces is caught here at plan time instead of silently
    computing tile-local physics at 3.8e10 photon-steps/s.
    """
    from physicl_tpu.state import SimState

    template = dataclasses.replace(SimState.zeros(16384), key=None,
                                   a=_TripLeaf("a"), extras=_TripExtras())
    label = "KernelStep(elementwise=True) fn"
    try:
        out = jax.eval_shape(lambda st: fn(st, _KernelCtxTrip()), template)
    except _KernelCtxUse as e:
        want = str(e)
        hint = ("randomness needs ElementwiseStep's p.uniform()"
                if "key" in want else
                "measurement needs ReduceMeasureStep"
                if want == "record" else
                "host/sim access is not elementwise")
        return ("ctx", f"{label} uses ctx.{want}: "
                       f"{hint} — the pipeline runs on the generic scan")
    except _KernelStateUse as e:
        what = str(e)
        hint = ("the in-kernel facade reads zeros for state.a while the "
                "generic path reads real accelerations"
                if what == "a" else
                "the in-kernel facade carries no extras planes (use "
                "ElementwiseStep with extras=)")
        return ("state", f"{label} uses state.{what}: {hint} — the "
                         "pipeline runs on the generic scan")
    except Exception as e:
        return ("trace", f"{label} failed abstract "
                         f"tracing ({type(e).__name__}: {e}); the pipeline "
                         "runs on the generic scan")
    if not isinstance(out, SimState):
        return ("return", f"{label} must return a "
                          f"SimState, got {type(out).__name__}; the "
                          "pipeline runs on the generic scan")
    for name in _KSTATE_WB:
        got, want = getattr(out, name), getattr(template, name)
        if got.shape != want.shape:
            return ("shape", f"{label} changed the "
                             f"shape of state.{name} ({want.shape} -> "
                             f"{got.shape}): not a per-particle map; the "
                             "pipeline runs on the generic scan")
    if not isinstance(out.a, _TripLeaf):
        return ("ignored-write", f"{label} writes state.a, which the fused "
                                 "kernel ignores but the generic path "
                                 "applies; the pipeline runs on the "
                                 "generic scan")
    if not isinstance(out.extras, _TripExtras):
        return ("ignored-write", f"{label} writes state.extras, which the "
                                 "fused kernel ignores but the generic "
                                 "path applies (use ElementwiseStep with "
                                 "extras_write=); the pipeline runs on "
                                 "the generic scan")

    # ---- phase 2: concrete behavioral checks on a tiny CPU state ----
    cap = 256
    base = _poisoned_concrete_state(cap, seed=1234)
    try:
        cpu = jax.devices("cpu")[0]
    except Exception:
        cpu = None

    def run(state):
        if cpu is not None:
            with jax.default_device(cpu):
                return fn(state, _KernelCtxTrip())
        return fn(state, _KernelCtxTrip())

    try:
        out0 = run(base)

        # scalar clock/census writes are ignored in-kernel
        for nm in ("t", "dt", "n_spawned", "t_comp"):
            if not _rows_equal(getattr(out0, nm), getattr(base, nm)):
                return ("ignored-write",
                        f"{label} changes state.{nm}, which the fused "
                        "kernel ignores but the generic path applies; "
                        "the pipeline runs on the generic scan")

        rng = np.random.default_rng(99)
        perm = rng.permutation(cap)

        def permute(state, p):
            return state.replace(
                r=state.r[:, p], dr=state.dr[:, p], v=state.v[:, p],
                dv=state.dv[:, p], E=state.E[p], alive=state.alive[p],
                otype=state.otype[p], w=state.w[p])

        out_p = run(permute(base, perm))
        for nm in _KSTATE_WB:
            got0, gotp = getattr(out0, nm), getattr(out_p, nm)
            if not _rows_equal(np.asarray(got0)[..., perm], gotp):
                return ("not-elementwise",
                        f"{label} is not a per-particle map: permuting the "
                        f"particle rows did not permute state.{nm} "
                        "identically (cross-particle gather/shift or "
                        "index-dependent physics) — inside the fused "
                        "kernel it would see one tile and silently "
                        "compute tile-local physics; the pipeline runs on "
                        "the generic scan")

        j = cap // 3
        bumped = base.replace(
            r=base.r.at[:, j].add(0.25), v=base.v.at[:, j].add(0.125),
            E=base.E.at[j].multiply(1.5), w=base.w.at[j].multiply(1.25))
        out_j = run(bumped)
        others = np.arange(cap) != j
        for nm in _KSTATE_WB:
            if not _rows_equal(getattr(out0, nm), getattr(out_j, nm),
                               rows=others):
                return ("not-elementwise",
                        f"{label} is not a per-particle map: perturbing "
                        f"one particle changed other particles' state.{nm} "
                        "(a cross-particle reduction) — inside the fused "
                        "kernel the reduction would silently be "
                        "tile-local; the pipeline runs on the generic "
                        "scan")

        doubled = base.replace(
            r=jnp.tile(base.r, (1, 2)), dr=jnp.tile(base.dr, (1, 2)),
            v=jnp.tile(base.v, (1, 2)), dv=jnp.tile(base.dv, (1, 2)),
            E=jnp.tile(base.E, 2), alive=jnp.tile(base.alive, 2),
            otype=jnp.tile(base.otype, 2), w=jnp.tile(base.w, 2))
        out_2 = run(doubled)
        for nm in _KSTATE_WB:
            if not _rows_equal(np.asarray(getattr(out_2, nm))[..., :cap],
                               getattr(out0, nm)):
                return ("not-elementwise",
                        f"{label} depends on the population capacity: "
                        f"state.{nm} changed per-row when the state was "
                        "tiled to twice the rows — inside the fused kernel "
                        "the 'capacity' is one tile; the pipeline "
                        "runs on the generic scan")
    except _KernelCtxUse as e:
        return ("ctx", f"{label} uses ctx.{e} — the pipeline runs on the "
                       "generic scan")
    except _KernelStateUse as e:
        return ("state", f"{label} uses state.{e}, which the in-kernel "
                         "facade cannot honor; the pipeline runs on the "
                         "generic scan")
    except Exception as e:
        return ("concrete", f"{label} failed the concrete plan-time probe "
                            f"({type(e).__name__}: {e}); the pipeline "
                            "runs on the generic scan")
    return None


def _probe_particle_fn(fn, ve, who):
    """Behavioral elementwise check for ParticleView-based user fns
    (:class:`~physicl_tpu.engine.ElementwiseStep` physics and
    :class:`~physicl_tpu.engine.ReduceMeasureStep` per-particle
    contributions). Same plan-time contract verification as
    :func:`_probe_kernelstep` phase 2: a row-permuted view must produce
    identically-permuted updates, perturbing one particle must not change
    other particles' updates, and tiling the population must not change
    per-row results. ``p.uniform()`` draws a constant plane (0.4375) so
    randomness is probe-transparent. None = honors the contract; else a
    (reason-slug, detail) pair.
    """
    from physicl_tpu.engine import ParticleView

    cap = 256
    rng = np.random.default_rng(4321)

    def build(sel=None, bump_row=None, tile=False):
        n = cap * 2 if tile else cap

        def plane(raw):
            arr = np.asarray(raw, np.float32)
            if tile:
                arr = np.tile(arr, 2)
            elif sel is not None:
                arr = arr[sel]
            return jnp.asarray(arr)

        raw_fields = {}
        rng2 = np.random.default_rng(4321)  # same draws every build
        for name in ParticleView._FIELDS:
            if name == "alive":
                raw_fields[name] = rng2.random(cap) < 0.8
            else:
                raw_fields[name] = np.asarray(
                    rng2.standard_normal(cap) + 1.5, np.float32)
        if bump_row is not None:
            for name in ("rx", "vx", "E", "w"):
                raw_fields[name] = raw_fields[name].copy()
                raw_fields[name][bump_row] *= 1.5
                raw_fields[name][bump_row] += 0.25
        fields = {k: (jnp.asarray(np.tile(v, 2) if tile else
                                  (v[sel] if sel is not None else v)))
                  if k == "alive" else plane(v)
                  for k, v in raw_fields.items()}
        ex = {}
        for nm, _p0, rows in ve:
            comps = []
            for i in range(rows):
                raw = np.asarray(rng2.random(cap) + 0.25, np.float32)
                if bump_row is not None and i == 0:
                    raw = raw.copy()
                    raw[bump_row] *= 1.5
                comps.append(plane(raw))
            ex[nm] = comps[0] if rows == 1 else tuple(comps)
        uniform = lambda: jnp.full((n,), 0.4375, jnp.float32)  # noqa: E731
        return ParticleView(fields, jnp.float32(0.8125),
                            jnp.float32(0.0625), uniform, extras=ex)

    try:
        cpu = jax.devices("cpu")[0]
    except Exception:
        cpu = None

    def run(view):
        if cpu is not None:
            with jax.default_device(cpu):
                return fn(view)
        return fn(view)

    def flat(upd):
        out = {}
        for k, v in upd.items():
            if isinstance(v, tuple):
                for i, c in enumerate(v):
                    out[f"{k}:{i}"] = c
            else:
                out[k] = v
        return out

    try:
        upd0 = flat(run(build()))
        perm = rng.permutation(cap)
        upd_p = flat(run(build(sel=perm)))
        for k in upd0:
            if np.ndim(upd0[k]) == 0:
                continue  # scalar updates broadcast; nothing to permute
            if not _rows_equal(np.asarray(upd0[k])[..., perm], upd_p[k]):
                return ("not-elementwise",
                        f"{who} fn is not a per-particle map: permuting "
                        f"the particle rows did not permute update "
                        f"{k!r} identically (cross-particle gather/shift "
                        "or index-dependent physics) — inside the fused "
                        "kernel it would silently compute tile-local "
                        "physics; the pipeline runs on the generic scan")
        j = cap // 3
        upd_j = flat(run(build(bump_row=j)))
        others = np.arange(cap) != j
        for k in upd0:
            if np.ndim(upd0[k]) == 0:
                if not _rows_equal(upd0[k], upd_j[k]):
                    return ("not-elementwise",
                            f"{who} fn update {k!r} is a scalar that "
                            "depends on other particles (a cross-particle "
                            "reduction); the pipeline runs on the "
                            "generic scan")
                continue
            if not _rows_equal(upd0[k], upd_j[k], rows=others):
                return ("not-elementwise",
                        f"{who} fn is not a per-particle map: perturbing "
                        f"one particle changed other particles' update "
                        f"{k!r} (a cross-particle reduction) — inside the "
                        "fused kernel the reduction would silently be "
                        "tile-local; the pipeline runs on the generic "
                        "scan")
        upd_2 = flat(run(build(tile=True)))
        for k in upd0:
            if np.ndim(upd0[k]) == 0:
                continue
            if not _rows_equal(np.asarray(upd_2[k])[..., :cap], upd0[k]):
                return ("not-elementwise",
                        f"{who} fn depends on the population capacity: "
                        f"update {k!r} changed per-row when the view was "
                        "tiled to twice the rows; the pipeline runs on "
                        "the generic scan")
    except Exception as e:
        return ("probe-error", f"{who} fn failed the concrete plan-time "
                               f"probe ({type(e).__name__}: {e}); the "
                               "pipeline runs on the generic scan")
    return None


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unharvested chunk: device futures + host schedule."""

    state: object            # optimistic post-chunk SimState (device futures)
    rec: object              # (K, 128) int32 device array
    rec_f: object            # (K, 128) f32 device array
    stream: object           # (K, n_stream, C) device array or None
    k_act: int               # live iterations this chunk (host-scheduled)
    done_t: bool             # t-mode exit fires inside this chunk
    ts: np.ndarray           # t after update, per iteration
    ts_before: np.ndarray    # t before update, per iteration
    dts_after: np.ndarray    # dt after update, per iteration
    t_opt: np.float32        # optimistic end-of-chunk clock
    dt_opt: np.float32
    dts_before: np.ndarray = None  # dt before update, per iteration
    comps: np.ndarray = None        # Kahan compensation after update
    comps_before: np.ndarray = None


class _StreamHold:
    """One chunk's stream buffer, shared by every trace step's record for
    that chunk — spilling it to host RAM (``arr`` reassignment) frees the
    device copy for ALL referencing steps at once. On process-spanning
    meshes a spill keeps only THIS host's contiguous span of the particle
    axis (``col0`` = global index of its first column) — the full stream is
    never gathered across hosts."""

    __slots__ = ("arr", "col0")

    def __init__(self, arr, col0: int = 0):
        self.arr = arr
        self.col0 = col0


@dataclasses.dataclass
class _TraceRaw:
    """Lazy trace record: the whole stream buffer + this step's plane offset.

    Handing the raw buffer to :class:`TracePathMeasureStep` avoids a per-chunk
    device slice copy (the buffer can be GBs per chunk); the step slices on
    the host at assembly time.
    """

    hold: _StreamHold  # shared (ceil(K/every), n_stream, C) buffer holder
    p0: int       # first plane: positions are planes [p0, p0+3)
    scat: bool    # plane p0+3 carries scatter-event flags
    every: int = 1     # kernel stream stride: row m holds iteration m*every
    op_every: int = 1  # this step's trace_every (a multiple of `every`)
    n_valid: int = -1  # trimmed by _collect_records (-1 == untrimmed);
    #                    counted in ITERATIONS, not buffer rows
    rows: object = None  # optional np row-index selection (set by the trace
    #                      step when its trace_every exceeds the kernel stride)

    @property
    def buf(self):
        return self.hold.arr

    def __getitem__(self, sl):
        """Valid-prefix trimming contract used by Simulation._collect_records
        (``v[:n_valid]``): record the bound instead of slicing the buffer."""
        if not (isinstance(sl, slice) and sl.start is None
                and sl.step is None):
            raise TypeError("_TraceRaw supports prefix slicing only")
        stop = sl.stop
        n_iters = self.buf.shape[0] * self.every
        n = n_iters if stop is None else min(stop, n_iters)
        return dataclasses.replace(self, n_valid=int(n))


class FusedProvider:
    """Callable matching the engine chunk contract, backed by the fused kernel."""

    def __init__(self, sim, plan: F.FusedPlan, rec_map: List[dict],
                 dt_fn, dt_before_kin: List[bool], measure_after_update:
                 Dict[str, bool], exit_fn, exit_mode: str):
        self.sim = sim
        self.plan = plan
        self.rec_map = rec_map
        self.dt_fn = dt_fn
        self.exit_fn = exit_fn
        self.exit_mode = exit_mode  # "t" | "n0"
        self.measure_after_update = measure_after_update
        self.kernel = None
        # Host clock mirrors: (t, comp) is the Kahan-compensated f32 clock —
        # the SAME arithmetic UpdateTimeStep.apply runs on-device for the
        # generic path, replayed here bit-for-bit, so ``sim.ts`` stays
        # byte-identical between paths while million-iteration runs stay
        # within ~1 ulp of the exact f64 sum (VERDICT r2 weak #3; the
        # reference keeps f64 sim.t, physicl/__init__.py:341-343). The full
        # clock state round-trips exactly through SimState (t, t_comp), so
        # kernel rebuilds are lossless.
        self.t_h = np.float32(0.0)
        self.dt_h = np.float32(0.0)
        self.comp_h = np.float32(0.0)
        self.n_h = 0
        self.hwm_h = 0  # host mirror of the device spawn mark
        self.capacity = 0
        self.chunk_idx = 0
        self.update_first = dt_before_kin
        self.emit_ops = [op for op in plan.ops if op.kind == "emit"]
        self.has_f_cols = any(
            (op.kind == "cross" and (op.weighted or any(
                e_col >= 0 for (_, _, _, e_col, _ecap) in op.axes)))
            or op.kind == "reduce"
            or (op.kind in ("sign", "scross") and op.weighted)
            # deposition / Compton-heating channels
            or (op.kind in ("del", "compton", "polc") and bool(op.cols))
            # polarization summaries (weight/p/V(/Q/U) sums)
            or op.kind == "polmeas"
            for op in plan.ops)
        # packed-state cache: when the engine hands back the SimState we
        # returned last chunk, reuse its packed buffer instead of re-packing
        # (saves a 14-plane concat + slice round trip per chunk)
        self._last_state = None
        self._last_packed = None

    def invalidate(self) -> None:
        """Drop compiled kernel + packed cache (capacity changed)."""
        self.kernel = None
        self._last_state = None
        self._last_packed = None

    def exit_pending(self) -> bool:
        """True when the next dispatch would run ZERO iterations — a
        declared t-exit already satisfied by the current host clock. Used
        to suppress chunk-boundary population control after the final full
        chunk (splitting a finished run changes the user-visible final
        state for no variance benefit)."""
        return (self.exit_mode == "t"
                and bool(self.exit_fn(_TOnly(self.t_h, self.dt_h))))

    def resync(self, state: SimState, counts=None) -> None:
        """Re-read host mirrors after an out-of-band state edit that kept
        the capacity (e.g. slot-recycling compaction); kernel stays
        compiled. ``counts=(n_alive, n_spawned)`` skips the device fetch
        when the caller already paid for it (each device_get is a host
        sync)."""
        self._last_state = None
        self._last_packed = None
        if counts is None:
            counts = jax.device_get((state.n_alive, state.n_spawned))
        self.n_h = int(counts[0])
        self.hwm_h = int(counts[1])

    def _host_schedule(self):
        """Replay K iterations of the time stepping on the host.

        Returns (ts, dts_kin, k_act, done_t): per-iteration time after the
        update step, dt in effect at kinematics, the number of live iterations
        this chunk, and whether a t-mode exit fires inside this chunk.

        The clock is the Kahan-compensated f32 sum — bit-identical to the
        generic path's on-device ``UpdateTimeStep.apply`` — so million-
        iteration runs with tiny dt neither stall at the f32 resolution
        limit nor drift off the exact exit count (within ~1 ulp of the f64
        sum), while ``sim.ts`` stays byte-identical between paths.
        """
        K = self.plan.chunk
        f32 = np.float32
        ts = np.zeros(K, f32)
        ts_before = np.zeros(K, f32)
        dts_kin = np.zeros(K, f32)
        dts_after = np.zeros(K, f32)
        dts_before = np.zeros(K, f32)
        comps = np.zeros(K, f32)
        comps_before = np.zeros(K, f32)
        n_emit = max(1, len(self.emit_ops))
        emit_starts = np.full((n_emit, K), _EMIT_INACTIVE, np.int32)
        hwm_after = np.full(K, self.hwm_h, np.int64)
        t, dt, comp = self.t_h, self.dt_h, self.comp_h
        hwm = self.hwm_h
        k_act, done_t = K, False

        def advance(t, dt, comp):
            # one Kahan step (all f32, matching the device arithmetic)
            y = f32(dt - comp)
            t_new = f32(t + y)
            comp = f32(f32(t_new - t) - y)
            return t_new, comp

        for i in range(K):
            if self.exit_mode == "t" and bool(self.exit_fn(_TOnly(t, dt))):
                k_act, done_t = i, True
                break
            ts_before[i] = t
            dts_before[i] = dt  # dt visible before this iteration's update
            comps_before[i] = comp
            if self.update_first:
                dt = f32(_as_f(self.dt_fn(_TOnly(t, dt))))
                t, comp = advance(t, dt, comp)
                dts_kin[i] = dt
            else:
                dts_kin[i] = dt  # kinematics uses last iteration's dt
                dt = f32(_as_f(self.dt_fn(_TOnly(t, dt))))
                t, comp = advance(t, dt, comp)
            ts[i] = t
            dts_after[i] = dt
            comps[i] = comp
            for j, op in enumerate(self.emit_ops):
                if hwm + op.emit_n <= self.capacity:
                    emit_starts[j, i] = hwm
                    hwm += op.emit_n
            hwm_after[i] = hwm
        return (ts, ts_before, dts_kin, dts_after, dts_before, k_act,
                done_t, emit_starts, hwm_after, comps, comps_before)

    def dispatch(self, state: SimState) -> "_Inflight":
        """Enqueue one chunk on the device and return a handle WITHOUT any
        host<->device synchronization.

        The host clock mirrors (t/dt/hwm) advance optimistically from the
        host-replayed schedule — exact for every chunk except the final one
        of an extinction run, where :meth:`harvest` trims them back. The
        device-visible cost of a dispatch is just the kernel enqueue, so the
        engine can pipeline: dispatch chunk k+1, then fetch chunk k's records
        while k+1 executes (the per-chunk host work otherwise serializes
        with the device in small-population workloads).
        """
        if self.kernel is None:
            if self.sim.mesh is not None:
                from physicl_tpu.parallel.sharding import build_sharded_fused

                self.kernel = build_sharded_fused(
                    self.plan, state.capacity, self.sim.mesh)
            else:
                self.kernel = F.build_fused_chunk(self.plan, state.capacity)
            # one host sync; (t, t_comp) is the COMPLETE Kahan clock
            # state, so reseeding after a rebuild is lossless
            n_h, t_h, dt_h, comp_h, hwm_h = jax.device_get(
                (state.n_alive, state.t, state.dt, state.t_comp,
                 state.n_spawned))
            self.n_h = int(n_h)
            self.t_h = np.float32(t_h)
            self.dt_h = np.float32(dt_h)
            self.comp_h = np.float32(comp_h)
            self.hwm_h = int(hwm_h)
            self.capacity = state.capacity

        (ts, ts_before, dts_kin, dts_after, dts_before, k_act, done_t,
         emit_starts, hwm_after, comps, comps_before) = self._host_schedule()

        seed = int(((int(self.sim.seed) * 2_654_435_761
                     + self.chunk_idx * 40_503) & 0xFFFFFFFF) & 0x7FFFFFFF)
        self.chunk_idx += 1

        if state is self._last_state and self._last_packed is not None:
            packed = self._last_packed
        else:
            packed = F.pack_state(state, self.plan.extras)
        # sched rows: [dt at kinematics, t after update, t before update,
        #              dt after update, dt before update] — already f32
        sched = np.stack([dts_kin, ts, ts_before,
                          dts_after, dts_before])
        res = self.kernel(packed, sched, emit_starts, seed, k_act)
        if self.plan.n_stream:
            packed, rec, rec_f, stream = res
        else:
            (packed, rec, rec_f), stream = res, None

        # Optimistic clock advance: schedule-exact in t-mode; in n0-mode also
        # exact for every chunk except the one where extinction fires — and
        # that one ends the run, so harvest() repairs the mirrors then.
        hwm_before = self.hwm_h
        if k_act:
            self.t_h = np.float32(ts[k_act - 1])
            self.dt_h = np.float32(dts_after[k_act - 1])
            self.comp_h = np.float32(comps[k_act - 1])
            self.hwm_h = int(hwm_after[k_act - 1])
            self.sim._hwm = self.hwm_h

        import jax.numpy as jnp
        new_state = F.unpack_state(packed, state, self.plan.extras,
                                   self.plan.extras_writeback).replace(
            t=jnp.asarray(float(self.t_h), state.t.dtype),
            dt=jnp.asarray(float(self.dt_h), state.dt.dtype),
            t_comp=jnp.asarray(float(self.comp_h), state.t.dtype),
            n_spawned=jnp.asarray(self.hwm_h, jnp.int32),
        )
        if self.hwm_h > hwm_before:
            # retype emitted slots in state.otype: on mixed plans the kernel
            # also writes the packed otype plane (same-chunk physics), but
            # only extras_writeback planes are read back, and photon-only
            # plans carry no otype plane at all — the host mirror is the
            # single source of truth for state.otype either way. Extras
            # planes of emitted slots zero in the same mirror pass (the
            # kernel zeroes its packed copies in-kernel; the generic
            # PhotonEmitterStep zeroes state.extras directly), so a later
            # re-pack after compaction/injection sees the same fresh slots.
            idx = jnp.arange(state.capacity)
            emitted = (idx >= hwm_before) & (idx < self.hwm_h)
            # writeback planes (Stokes/frame) are already authoritative
            # from the kernel — zeroing them here would erase a polarized
            # source's configured emission values
            wb = set(self.plan.extras_writeback)
            new_state = new_state.replace(
                otype=jnp.where(emitted, jnp.int32(OBJ_PHOTON),
                                new_state.otype),
                extras={k: (v if k in wb else
                            jnp.where(emitted, jnp.zeros((), v.dtype), v))
                        for k, v in new_state.extras.items()})
        self._last_state = new_state
        self._last_packed = packed
        # start the record transfer now: it begins the moment the kernel
        # retires, so by harvest time the host copy is (usually) already
        # resident and the fetch costs no extra host sync
        for arr in ((rec, rec_f) if self.has_f_cols else (rec,)):
            copy_async = getattr(arr, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()
        return _Inflight(
            state=new_state, rec=rec, rec_f=rec_f, stream=stream,
            k_act=k_act, done_t=done_t, ts=ts, ts_before=ts_before,
            dts_after=dts_after, dts_before=dts_before,
            comps=comps, comps_before=comps_before,
            t_opt=np.float32(self.t_h), dt_opt=np.float32(self.dt_h),
        )

    def harvest(self, inflight: "_Inflight"):
        """Fetch a dispatched chunk's records (the one blocking round trip)
        and classify its exit. Returns ``(done, final_state, records,
        n_valid, stats)`` — ``final_state`` is the definitive post-chunk state
        (== the dispatched one except when an extinction trim repaired t/dt).
        Chunks MUST be harvested in dispatch order: the alive-count chain
        ``n_before`` threads through consecutive harvests.
        """
        K = self.plan.chunk
        k_act = inflight.k_act
        rec_np = np.asarray(jax.device_get(inflight.rec))
        recf_np = (np.asarray(jax.device_get(inflight.rec_f))
                   if self.has_f_cols else None)

        n_end = rec_np[:, 0]
        n_before = np.concatenate([[self.n_h], n_end[:-1]])

        if self.exit_mode == "n0":
            alive_iters = n_before > 0
            n_valid = int((alive_iters & (np.arange(K) < k_act)).sum())
            done = bool((~alive_iters[:k_act]).any())
        else:
            n_valid = k_act
            done = inflight.done_t

        if n_valid:
            self.n_h = int(n_end[n_valid - 1])

        final_state = inflight.state
        if done and self.exit_mode == "n0" and n_valid < k_act:
            # extinction fired mid-chunk: the optimistic clocks overshot by
            # (k_act - n_valid) iterations; trim them and repair the state
            import jax.numpy as jnp

            if n_valid:
                t_fix = np.float32(inflight.ts[n_valid - 1])
                dt_fix = np.float32(inflight.dts_after[n_valid - 1])
                comp_fix = np.float32(inflight.comps[n_valid - 1])
            else:
                # extinction was already visible at the chunk's first
                # iteration: the clocks stay at the previous chunk's end,
                # which the schedule recorded as this chunk's starting point
                t_fix = np.float32(inflight.ts_before[0])
                dt_fix = np.float32(inflight.dts_before[0])
                comp_fix = np.float32(inflight.comps_before[0])
            self.t_h, self.dt_h, self.comp_h = t_fix, dt_fix, comp_fix
            final_state = inflight.state.replace(
                t=jnp.asarray(float(t_fix), inflight.state.t.dtype),
                dt=jnp.asarray(float(dt_fix), inflight.state.dt.dtype),
                t_comp=jnp.asarray(float(comp_fix),
                                   inflight.state.t.dtype),
            )
            self._last_state = final_state
        stats = {"t": float(self.t_h if done else inflight.t_opt),
                 "dt": float(self.dt_h if done else inflight.dt_opt),
                 "n_alive": int(self.n_h)}
        # host stats for the engine (saves per-chunk device_get round trips)
        self.host_stats = stats

        ts, ts_before, stream = inflight.ts, inflight.ts_before, inflight.stream
        records = {}
        # one shared holder per chunk: all trace steps reference the SAME
        # device buffer, so spill accounting / release must be collective
        stream_hold = (_StreamHold(stream)
                       if any(m["kind"] == "trace" for m in self.rec_map)
                       else None)
        for m in self.rec_map:
            uid = m["uid"]
            kind = m["kind"]
            t_arr = ts if self.measure_after_update.get(uid, True) else ts_before
            if kind == "ts":
                records[f"{uid}/ts"] = ts
            elif kind == "dep":
                records[f"{uid}/t"] = t_arr
                records[f"{uid}/dep"] = recf_np[:, m["col"]]
            elif kind == "sign":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                src = recf_np if m.get("weighted") else rec_np
                records[f"{uid}/signs"] = src[:, m["sx_col"]:m["sx_col"] + 3]
            elif kind == "cross":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                src = recf_np if m.get("weighted") else rec_np
                for j, col in enumerate(m["cnt_cols"]):
                    records[f"{uid}/count{j}"] = src[:, col]
                for j, col in enumerate(m.get("e_cols", [])):
                    if col >= 0:
                        records[f"{uid}/Esum{j}"] = recf_np[:, col]
                for j, p in enumerate(m.get("ecap_planes", [])):
                    if p >= 0:  # per-photon E capture, NaN-coded (K, C)
                        records[f"{uid}/E{j}"] = stream[:, p, :]
            elif kind == "reduce":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                for j, name in enumerate(m["names"]):
                    records[f"{uid}/{name}"] = recf_np[:, m["f0"] + j]
            elif kind == "polmeas":
                # kernel tallies weight/p/V(/Q/U) SUMS; divide by the weight
                # sum to recover the generic path's per-iteration means
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                f0 = m["f0"]
                denom = np.maximum(recf_np[:, f0], 1e-30)
                records[f"{uid}/p_mean"] = recf_np[:, f0 + 1] / denom
                records[f"{uid}/V_mean"] = recf_np[:, f0 + 2] / denom
                if m["local_qu"]:
                    records[f"{uid}/Q_mean"] = recf_np[:, f0 + 3] / denom
                    records[f"{uid}/U_mean"] = recf_np[:, f0 + 4] / denom
            elif kind == "trace":
                # device-resident: the step receives the RAW stream buffer
                # plus plane offsets and slices lazily at assembly time —
                # per-chunk device slicing would copy the (K, planes, C)
                # buffer every chunk for nothing
                records[f"{uid}/traceraw"] = _TraceRaw(
                    hold=stream_hold, p0=m["p0"], scat=m["scat"],
                    every=self.plan.stream_every, op_every=m["every"])

        return done, final_state, records, n_valid, stats

    def __call__(self, state: SimState):
        """Engine chunk contract (dispatch + immediate harvest): kept for
        direct callers (benchmarks, notebooks); the engine itself uses the
        pipelined dispatch/harvest pair."""
        inflight = self.dispatch(state)
        done, final_state, records, n_valid, _stats = self.harvest(inflight)
        valid = np.arange(self.plan.chunk) < n_valid
        return final_state, done, records, valid


def try_build_fused(sim, steps, state: SimState,
                    report: Optional[list] = None) -> Optional[FusedProvider]:
    """Return a FusedProvider if the sim is provably fusable, else None.

    When ``report`` is a list, every refusal appends a ``(code, detail)``
    pair explaining exactly why the fused pipeline was not used — surfaced
    to users through :meth:`Simulation.explain_plan` and the one-time
    fallback warning (the reference's ``cl_on`` switch was at least
    explicit; our fused/generic split must be at least as visible).
    """
    def _no(code: str, detail: str):
        if report is not None:
            report.append((code, detail))
        return None

    from physicl_tpu.engine import (
        ElementwiseStep,
        ReduceMeasureStep,
        UpdateTimeStep,
    )
    from physicl_tpu.kernels import KernelStep
    from physicl_tpu.newton import (
        AbsorbingBoundaryStep,
        AbsorbingSphereStep,
        LorentzForceStep,
        NewtonianKinematicsStep,
        PeriodicBoundaryStep,
        ReflectingBoundaryStep,
        _static_bounds,
    )
    from physicl_tpu.light import (
        PhotonEmitterStep,
        RefractiveInterfaceStep,
        ScatterComptonStep,
        ScatterDeleteStep,
        ScatterHenyeyGreensteinStep,
        ScatterPhaseFunctionStep,
        ScatterRayleighStep,
        ScatterIsotropicStep,
        ScatterMeasureStep,
        ScatterSignMeasureStep,
        SphericalShellMeasureStep,
        TracePathMeasureStep,
    )
    from physicl_tpu.polarization import (
        ScatterPolarizedComptonStep,
        ScatterPolarizedRayleighStep,
        StokesMeasureStep,
    )

    def _population_pol_planes(sim) -> tuple:
        """The subset of ("stokes", "pol_ref") declared by any pending
        source. The generic fluorescence apply zeroes each plane
        independently, so a half-declared population (only one of the
        two) must still pack+write back that one plane on the fused path
        or re-emitted photons keep stale host polarization."""
        found = set()
        for b in sim._pending_bulk:
            ex = b.get("extras") or {}
            found.update(nm for nm in ("stokes", "pol_ref") if nm in ex)
        for o in sim._pending_objects:
            found.update(nm for nm in ("stokes", "pol_ref")
                         if hasattr(o, nm))
        return tuple(nm for nm in ("stokes", "pol_ref") if nm in found)

    def _population_has_stokes(sim) -> bool:
        """At least one pending source declares BOTH polarization planes
        (state assembly zero-fills the rest: unpolarized, degenerate
        frame) — the requirement for the polarized scatter/measure ops."""
        return _population_pol_planes(sim) == ("stokes", "pol_ref")

    _EXTRAS_CORE = {"r", "dr", "v", "dv", "a", "E", "w"}

    def _population_extras_rows(name: str):
        """Row count the state assembly will give a pending extras plane
        (1 for scalars, 3 for 3-vectors — state.py extras_spec), or None
        if no pending source declares it. Host-side knowledge only."""
        if name.startswith("_") or name in _EXTRAS_CORE:
            return None
        for b in sim._pending_bulk:
            arr = (b.get("extras") or {}).get(name)
            if arr is not None:
                return 1 if np.asarray(arr).ndim == 1 else 3
        for o in sim._pending_objects:
            if hasattr(o, name):
                arr = np.asarray(raw_code_value(getattr(o, name)),
                                 dtype=np.float64)
                if arr.shape == ():
                    return 1
                if arr.shape == (3,):
                    return 3
        return None

    def _resolve_view_extras(s):
        """(name, first_packed_plane, rows) entries for a step's declared
        read-only extras, appending packed plane names as needed; the str
        return is the name of a plane the population does not carry."""
        entries = []
        for name in s.extras:
            rows = _population_extras_rows(name)
            if rows is None:
                return name
            packed = ([name] if rows == 1
                      else [f"{name}:{i}" for i in range(rows)])
            for nm in packed:
                if nm not in extra_names:
                    extra_names.append(nm)
            entries.append((name, F._NF + extra_names.index(packed[0]),
                            rows))
        return tuple(entries)

    if not getattr(sim, "jit_on", True):
        return _no("jit-off", "jit_on=False: the fused pipeline "
                   "requires compilation")

    # Population species (host-side knowledge, no device sync). A uniform
    # population lets the fused kernel elide per-particle type dispatch
    # entirely — photons (the transport pipeline) or generic/charged
    # particles (kinematics + Lorentz + boundaries + measures). A MIXED
    # population packs the otype codes as a read-only extras plane and
    # gates photon physics per particle in-kernel.
    codes = {int(getattr(o, "_obj_type_code", 0))
             for o in sim._pending_objects}
    codes |= {int(b["otype"]) for b in sim._pending_bulk}
    if not codes:
        return _no("empty-population",
                   "no initial objects: add particles before start() "
                   "(in-kernel emitters still need a sized arena)")
    species = codes.pop() if len(codes) == 1 else F.SPECIES_MIXED
    if species not in (OBJ_PHOTON, F.SPECIES_MIXED) and any(
            type(s) is PhotonEmitterStep for s in steps):
        # an emitter turns a non-photon population mixed at its first
        # emission — plan the mixed kernel (otype-gated photon physics)
        # up front instead of refusing as "photon-only ops on non-photons"
        species = F.SPECIES_MIXED

    ops: List[F._Op] = []
    rec_map: List[dict] = []
    measure_after_update: Dict[str, bool] = {}
    extra_names: List[str] = []  # packed planes after the core 15
    pol_wb: set = set()  # polarization plane bases mutated in-kernel
    user_wb: list = []   # user extras_write bases (declaration order)
    if species == F.SPECIES_MIXED:
        extra_names.append("otype")
    next_col = 1
    next_fcol = 0   # float record channels (energy sums)
    next_plane = 0  # stream planes (trace positions, per-photon E capture)
    dt_fn = None
    update_seen = False
    update_before_kin = False
    kin_seen = False

    # Photon physics is otype-filtered on the generic path (e.g.
    # light.py ScatterDeleteStep.apply's `state.otype == OBJ_PHOTON`).
    # Photon-only populations fuse these with no dispatch at all; mixed
    # populations gate them per particle through the packed otype plane;
    # a PURE non-photon population keeps them on the generic path (they
    # are exact no-ops there — fusing would only hide a likely user error).
    photon_only = (ScatterDeleteStep, ScatterIsotropicStep,
                   ScatterHenyeyGreensteinStep, ScatterRayleighStep,
                   ScatterPolarizedRayleighStep, ScatterPolarizedComptonStep,
                   ScatterComptonStep, RefractiveInterfaceStep,
                   PhotonEmitterStep)

    for s in steps:
        uid = s._step_uid
        if getattr(s, "at_boundary", False) and hasattr(s, "boundary_apply"):
            # chunk-boundary population control (light._SplitBase
            # at="chunk"): applied between dispatches by the
            # PopulationManager, not inside the kernel — contributes no op
            continue
        # field callables that declare they cannot enter the fused chunk
        # (light.voxel_density grids past the fused voxel caps) force the
        # generic scan with a structured reason
        for attr in ("_n_fn", "_a_fn"):
            f = getattr(s, attr, None)
            if f is not None and getattr(f, "pallas_incompatible", False):
                return _no("field-fn-gather",
                           f"{type(s).__name__}'s "
                           f"{'density' if attr == '_n_fn' else 'cross-'}"
                           f"{'' if attr == '_n_fn' else 'section'} field "
                           "callable declares pallas_incompatible (voxel "
                           "grid beyond the fused voxel caps: "
                           "> 256 distinct values past "
                           "light.MAX_FUSED_VOXELS); the pipeline runs on "
                           "the generic scan — voxel_density(quantize=K) "
                           "snaps continuous grids to a fusable codebook "
                           "(declared on both paths), or coarsen the "
                           "grid / use light.layered_density")
        if isinstance(s, photon_only):
            if species not in (OBJ_PHOTON, F.SPECIES_MIXED):
                # unreachable for PhotonEmitterStep (promoted to a mixed
                # plan above); the remaining photon ops ARE exact no-ops
                # on a population that contains no photons and no source
                return _no("photon-only-op",
                           f"{type(s).__name__} acts on photons but the "
                           "population is non-photon (and no emitter adds "
                           "any); it is an exact no-op here, so this "
                           "pipeline runs on the generic path")
        if type(s) is UpdateTimeStep:
            if update_seen:
                return _no("duplicate-update-step",
                           "more than one UpdateTimeStep; the fused time "
                           "schedule is replayed from a single dt function")
            if not _probe_t_only(s.fn):
                return _no("dt-fn-not-t-only",
                           "the UpdateTimeStep function reads sim attributes "
                           "beyond (t, dt); the host time-schedule replay "
                           "can only feed it the clock")
            update_seen = True
            update_before_kin = not kin_seen
            dt_fn = s.fn
            rec_map.append({"uid": uid, "kind": "ts"})
        elif type(s) is NewtonianKinematicsStep:
            if getattr(s, "integrate_acceleration", False):
                # acceleration lives outside the packed fields
                return _no("kinematics-acceleration",
                           "NewtonianKinematicsStep(integrate_acceleration="
                           "True): a/dv planes are not in the packed kernel "
                           "state")
            kin_seen = True
            ops.append(F._Op("kin"))
        elif type(s) is ScatterDeleteStep:
            dep_cols = ()
            if getattr(s, "measure_deposition", False):
                dep_cols = (next_fcol,)   # per-iteration deposited energy
                next_fcol += 1
                rec_map.append({"uid": uid, "kind": "dep",
                                "col": dep_cols[0]})
                measure_after_update[uid] = update_seen
            if getattr(s, "fluorescence", None):
                # fluorescent re-emission zeroes the Stokes/frame planes of
                # re-emitted lanes in-kernel (unpolarized emission) — the
                # planes must be packed AND written back even without a
                # polarized scatter op in the pipeline, or the host state
                # keeps the stale pre-absorption polarization the generic
                # path clears. Per-plane: the generic apply zeroes each
                # independently, so a population declaring only one of
                # stokes/pol_ref still needs that one packed.
                for base in _population_pol_planes(sim):
                    for nm in (f"{base}:0", f"{base}:1", f"{base}:2"):
                        if nm not in extra_names:
                            extra_names.append(nm)
                    pol_wb.add(base)
            ops.append(F._Op("del", coef=s._coef, a_fn=s._a_fn,
                             n_fn=s._n_fn,
                             implicit_capture=s.implicit_capture,
                             roulette=(tuple(s.roulette)
                                       if s.roulette else ()),
                             stretch=(tuple(s.stretch)
                                      if getattr(s, "stretch", None)
                                      else ()),
                             fluor=(tuple(s.fluorescence)
                                    if getattr(s, "fluorescence", None)
                                    else ()),
                             c_val=s._c,
                             cols=dep_cols))
        elif type(s) is AbsorbingBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("absorb", bounds=_static_bounds(s, sim)))
        elif type(s) is AbsorbingSphereStep:
            ops.append(F._Op("sabsorb", sphere=(*s.center, s.radius),
                             inside=s.kill_inside))
        elif type(s) is ReflectingBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("reflect", bounds=_static_bounds(s, sim)))
        elif type(s) is PeriodicBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("periodic", bounds=_static_bounds(s, sim)))
        elif type(s) is LorentzForceStep:
            if s.q_over_m is None:
                # per-particle q/m packs as a derived extras plane — but only
                # when the population actually declares the extras; otherwise
                # the generic path raises its instructive ValueError, which
                # must surface (a fused silent no-op would hide the bug)
                has_qm = (any(hasattr(o, "q") for o in sim._pending_objects)
                          and any(hasattr(o, "m")
                                  for o in sim._pending_objects))
                if not has_qm:
                    return _no("lorentz-per-particle",
                               "LorentzForceStep(q_over_m=None) needs "
                               "per-particle q/m extras and no initial "
                               "object declares q= and m= "
                               "(newton.ChargedObject); the generic path "
                               "raises the instructive error")
            if species == OBJ_PHOTON:
                # photons are never pushed (generic path's
                # `otype != OBJ_PHOTON` filter) — but the generic apply still
                # ZEROES dv ("dv = this step's velocity change"), which a
                # downstream trace_dv counts on. qm=0, no fields reproduces
                # exactly that: v unchanged, dv = 0.
                ops.append(F._Op("lorentz", qm=0.0,
                                 after_update=update_seen))
            elif s.q_over_m is not None:
                ops.append(F._Op("lorentz", qm=s.q_over_m,
                                 e_const=s._e_const or (),
                                 b_const=s._b_const or (),
                                 e_fn=None if s._e_const else s._e_fn,
                                 b_fn=None if s._b_const else s._b_fn,
                                 after_update=update_seen))
            else:
                if "qm" not in extra_names:
                    extra_names.append("qm")
                ops.append(F._Op(
                    "lorentz", qm_plane=F._NF + extra_names.index("qm"),
                    e_const=s._e_const or (), b_const=s._b_const or (),
                    e_fn=None if s._e_const else s._e_fn,
                    b_fn=None if s._b_const else s._b_fn,
                    after_update=update_seen))
        elif type(s) is ScatterIsotropicStep:
            s.setup(sim)
            ops.append(F._Op(
                "iso", coef=s._coef, wl_base=s._wl_base, n_fn=s._n_fn,
                c_val=s._c,
            ))
        elif type(s) is ScatterHenyeyGreensteinStep:
            s.setup(sim)
            ops.append(F._Op(
                "hg", coef=s._coef, wl_base=s._wl_base, n_fn=s._n_fn,
                c_val=s._c, g=s.g,
            ))
        elif type(s) is ScatterPhaseFunctionStep:
            s.setup(sim)
            ops.append(F._Op(
                "phase", coef=s._coef, wl_base=s._wl_base, n_fn=s._n_fn,
                c_val=s._c, custom_fn=s._icdf,
            ))
        elif type(s) is ScatterRayleighStep:
            s.setup(sim)
            ops.append(F._Op(
                "rayl", coef=s._coef, wl_base=s._wl_base, n_fn=s._n_fn,
                c_val=s._c,
            ))
        elif type(s) is ScatterPolarizedRayleighStep:
            if not _population_has_stokes(sim):
                # the generic apply raises the instructive "build it with
                # polarized_photon_state" error — that must surface
                return _no("polarization-planes",
                           "ScatterPolarizedRayleighStep but no pending "
                           "population declares 'stokes' + 'pol_ref' extras "
                           "(polarization.polarized_photon_state); the "
                           "generic path raises the instructive error")
            s.setup(sim)
            for nm in ("stokes:0", "stokes:1", "stokes:2",
                       "pol_ref:0", "pol_ref:1", "pol_ref:2"):
                if nm not in extra_names:
                    extra_names.append(nm)
            pol_wb.update(("stokes", "pol_ref"))
            ops.append(F._Op(
                "pol", coef=s._coef, wl_base=s._wl_base, n_fn=s._n_fn,
                c_val=s._c,
                pol_planes=(F._NF + extra_names.index("stokes:0"),
                            F._NF + extra_names.index("pol_ref:0"))))
        elif type(s) is ScatterPolarizedComptonStep:
            if not _population_has_stokes(sim):
                return _no("polarization-planes",
                           "ScatterPolarizedComptonStep but no pending "
                           "population declares 'stokes' + 'pol_ref' extras "
                           "(polarization.polarized_photon_state); the "
                           "generic path raises the instructive error")
            s.setup(sim)
            for nm in ("stokes:0", "stokes:1", "stokes:2",
                       "pol_ref:0", "pol_ref:1", "pol_ref:2"):
                if nm not in extra_names:
                    extra_names.append(nm)
            pol_wb.update(("stokes", "pol_ref"))
            dep_cols = ()
            if s.measure_deposition:
                dep_cols = (next_fcol,)   # Compton heating per iteration
                next_fcol += 1
                rec_map.append({"uid": uid, "kind": "dep",
                                "col": dep_cols[0]})
                measure_after_update[uid] = update_seen
            ops.append(F._Op(
                "polc", coef=s._coef, n_fn=s._n_fn, c_val=s._c,
                inv_mec2=s._inv_mec2, kn_xsec=s.kn_cross_section,
                kn_tries=s.kn_max_tries, cols=dep_cols,
                pol_planes=(F._NF + extra_names.index("stokes:0"),
                            F._NF + extra_names.index("pol_ref:0"))))
        elif type(s) is StokesMeasureStep:
            if not _population_has_stokes(sim):
                return _no("polarization-planes",
                           "StokesMeasureStep but no pending population "
                           "declares 'stokes' + 'pol_ref' extras "
                           "(polarization.polarized_photon_state); the "
                           "generic path raises the instructive error")
            for nm in ("stokes:0", "stokes:1", "stokes:2"):
                if nm not in extra_names:
                    extra_names.append(nm)
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            f0 = next_fcol
            outs = ("wt", "p", "V") + (("Q", "U") if s.local_qu else ())
            next_fcol += len(outs)
            ops.append(F._Op(
                "polmeas", cols=(n_col, f0), weighted=s.weighted,
                reduce_outputs=outs,
                pol_planes=(F._NF + extra_names.index("stokes:0"),)))
            rec_map.append({"uid": uid, "kind": "polmeas", "n_col": n_col,
                            "f0": f0, "local_qu": s.local_qu})
            measure_after_update[uid] = update_seen
        elif type(s) is ScatterComptonStep:
            s.setup(sim)
            dep_cols = ()
            if getattr(s, "measure_deposition", False):
                dep_cols = (next_fcol,)   # Compton heating per iteration
                next_fcol += 1
                rec_map.append({"uid": uid, "kind": "dep",
                                "col": dep_cols[0]})
                measure_after_update[uid] = update_seen
            ops.append(F._Op(
                "compton", coef=s._coef, n_fn=s._n_fn, c_val=s._c,
                inv_mec2=s._inv_mec2, kn_xsec=s.kn_cross_section,
                kn_tries=s.kn_max_tries, theta_e=float(s._theta_e or 0.0),
                cols=dep_cols,
            ))
        elif type(s) is RefractiveInterfaceStep:
            s.setup(sim)
            ops.append(F._Op(
                "fresnel", c_val=float(s._c),
                iface=(s.axis, float(s.loc), s.n_lo, s.n_hi,
                       s.match_speed)))
        elif type(s) is PhotonEmitterStep:
            # sampled energies fuse when the sampler exposes a traced
            # inverse CDF over a uniform (PlanckSampler protocol); arbitrary
            # key-based samplers need the generic path's jax.random keys
            if callable(s.E) and not hasattr(s.E, "icdf"):
                return _no("emitter-sampler",
                           f"PhotonEmitterStep energy sampler "
                           f"{type(s.E).__name__} exposes no .icdf(u); "
                           "in-kernel sampling needs a traced inverse CDF "
                           "over a uniform (PlanckSampler protocol)")
            s.setup(sim)
            if s.isotropic:
                emit_v = None
            elif s.v is None:
                emit_v = (s._c, 0.0, 0.0)
            else:
                emit_v = tuple(
                    float(x) for x in np.asarray(
                        raw_code_value(s.v), np.float64).reshape(3))
            emit_stokes, emit_polref = (), ()
            if getattr(s, "stokes", None) is not None:
                if not _population_has_stokes(sim):
                    # the generic apply raises the instructive error
                    return _no("polarization-planes",
                               "polarized PhotonEmitterStep (stokes=) but "
                               "no pending population declares 'stokes' + "
                               "'pol_ref' extras (polarization."
                               "polarized_photon_state); the generic path "
                               "raises the instructive error")
                for nm in ("stokes:0", "stokes:1", "stokes:2",
                           "pol_ref:0", "pol_ref:1", "pol_ref:2"):
                    if nm not in extra_names:
                        extra_names.append(nm)
                pol_wb.update(("stokes", "pol_ref"))
                emit_stokes = tuple(float(x) for x in s.stokes)
                emit_polref = tuple(float(x) for x in s._emit_e1)
            ops.append(F._Op(
                "emit", emit_n=s.n_per_step,
                emit_E=(0.0 if callable(s.E)
                        else float(raw_code_value(s.E))),
                emit_E_fn=(s.E.icdf if callable(s.E) else None),
                emit_r=tuple(float(x) for x in s.r),
                emit_v=emit_v, c_val=s._c,
                emit_sched_idx=sum(1 for o in ops if o.kind == "emit"),
                emit_stokes=emit_stokes, emit_polref=emit_polref,
            ))
        elif type(s) is SphericalShellMeasureStep:
            n_col = -1
            if s.measure_n:
                n_col = next_col
                next_col += 1
            if s.weighted:
                col = next_fcol
                next_fcol += 1
            else:
                col = next_col
                next_col += 1
            ops.append(F._Op("scross", sphere=(*s.center, s.radius),
                             cols=(n_col, col), weighted=s.weighted))
            rec_map.append({"uid": uid, "kind": "cross", "n_col": n_col,
                            "cnt_cols": [col], "weighted": s.weighted})
            measure_after_update[uid] = update_seen
        elif type(s) is ScatterSignMeasureStep:
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            weighted = getattr(s, "weighted", False)
            if weighted:   # weight sums live in float record channels
                sx = next_fcol
                next_fcol += 3
            else:
                sx = next_col
                next_col += 3
            ops.append(F._Op("sign", cols=(n_col, sx), weighted=weighted))
            rec_map.append({"uid": uid, "kind": "sign", "n_col": n_col,
                            "sx_col": sx, "weighted": weighted})
            measure_after_update[uid] = update_seen
        elif type(s) is ScatterMeasureStep:
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            want_sum = s.measure_E and s.measure_E_mode == "sum"
            want_list = s.measure_E and s.measure_E_mode == "list"
            weighted = getattr(s, "weighted", False)
            axes, cnt_cols, e_cols, ecap_planes = [], [], [], []
            for axis, L in s._axes:
                e_col = -1
                ecap = -1
                if want_sum:
                    e_col = next_fcol
                    next_fcol += 1
                elif want_list:  # per-photon E capture: one stream plane
                    ecap = next_plane
                    next_plane += 1
                if weighted:   # weight sums live in float record channels
                    cnt = next_fcol
                    next_fcol += 1
                else:
                    cnt = next_col
                    next_col += 1
                axes.append((axis, L, cnt, e_col, ecap))
                cnt_cols.append(cnt)
                e_cols.append(e_col)
                ecap_planes.append(ecap)
            ops.append(F._Op("cross", cols=(n_col,), axes=tuple(axes),
                             weighted=weighted))
            rec_map.append({"uid": uid, "kind": "cross", "n_col": n_col,
                            "cnt_cols": cnt_cols, "e_cols": e_cols,
                            "ecap_planes": ecap_planes,
                            "weighted": weighted})
            measure_after_update[uid] = update_seen
        elif type(s) is ElementwiseStep:
            # user physics under the elementwise contract traces straight
            # into the kernel; t row chosen by position vs UpdateTimeStep.
            # Declared extras pack as planes after the core 15; planes in
            # extras_write= additionally join the plan's writeback list so
            # the kernel's stores flow back into state.extras each chunk
            ve = _resolve_view_extras(s)
            if isinstance(ve, str):
                return _no("extras-missing",
                           f"ElementwiseStep declares extras={s.extras} "
                           f"but no pending population carries a '{ve}' "
                           "plane; the generic path raises the "
                           "instructive error")
            why = _probe_particle_fn(s.fn, ve, "ElementwiseStep")
            if why is not None:
                return _no(f"elementwise-{why[0]}", why[1])
            for nm in getattr(s, "extras_write", ()):
                user_wb.append(nm)
            ops.append(F._Op("custom", custom_fn=s.fn,
                             after_update=update_seen, view_extras=ve,
                             extras_write=tuple(
                                 getattr(s, "extras_write", ()))))
        elif isinstance(s, ReduceMeasureStep) and (
                type(s).apply is ReduceMeasureStep.apply
                and type(s)._contributions is ReduceMeasureStep._contributions):
            # user per-particle measurement: one float record channel per
            # declared output, summed over alive particles in-kernel.
            # Subclasses that only configure the constructor (e.g. light.
            # SpectrumMeasureStep) stay fused: the kernel traces s.fn, which
            # fully determines their semantics; a subclass overriding apply
            # or _contributions falls through to unsupported-step instead of
            # being silently fused with base behavior.
            ve = _resolve_view_extras(s)
            if isinstance(ve, str):
                return _no("extras-missing",
                           f"ReduceMeasureStep declares extras={s.extras} "
                           f"but no pending population carries a '{ve}' "
                           "plane; the generic path raises the "
                           "instructive error")
            why = _probe_particle_fn(s.fn, ve, "ReduceMeasureStep")
            if why is not None:
                return _no(f"reduce-{why[0]}", why[1])
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            f0 = next_fcol
            next_fcol += len(s.outputs)
            ops.append(F._Op("reduce", custom_fn=s.fn,
                             reduce_outputs=s.outputs, view_extras=ve,
                             cols=(n_col, f0), after_update=update_seen))
            rec_map.append({"uid": uid, "kind": "reduce", "n_col": n_col,
                            "f0": f0, "names": s.outputs})
            measure_after_update[uid] = update_seen
        elif type(s) is TracePathMeasureStep:
            p0 = next_plane
            next_plane += 3 + (1 if s.trace_dv else 0)
            every = int(getattr(s, "trace_every", 1))
            ops.append(F._Op("trace", stream0=p0, stream_scat=s.trace_dv,
                             stream_every=every))
            rec_map.append({"uid": uid, "kind": "trace", "p0": p0,
                            "scat": s.trace_dv, "every": every})
        elif type(s) is KernelStep and getattr(s, "elementwise", False):
            # user's per-particle contract (kernels.KernelStep docstring):
            # trace the SimState->SimState map into the kernel. record_fn
            # and ctx use (PRNG keys, records) have no in-kernel meaning —
            # structured refusals route those to the generic scan
            if s.record_fn is not None:
                return _no("kernelstep-records",
                           "KernelStep(elementwise=True) with record_fn=: "
                           "records reduce across particles; use "
                           "ReduceMeasureStep for fused measurement — the "
                           "pipeline runs on the generic scan")
            why = _probe_kernelstep(s.fn, sim)
            if why is not None:
                return _no(f"kernelstep-{why[0]}", why[1])
            ops.append(F._Op("kstate", custom_fn=s.fn,
                             after_update=update_seen))
        else:
            return _no("unsupported-step",
                       f"{type(s).__name__} has no fused-kernel op; "
                       "supported: UpdateTime/Kinematics/Lorentz/"
                       "ScatterDelete/ScatterIsotropic/"
                       "ScatterHenyeyGreenstein/ScatterRayleigh/"
                       "ScatterPolarized(Rayleigh|Compton)/PhaseFunction/"
                       "ScatterCompton/RefractiveInterface/boundaries/"
                       "PhotonEmitter/Sign+Cross+Reduce+Stokes measures/"
                       "Elementwise/TracePath/KernelStep(elementwise=True)")

    if not update_seen:
        return _no("no-update-step",
                   "no UpdateTimeStep: the fused kernel precomputes the "
                   "time schedule on the host and needs a dt function")
    if next_col > F._MAX_REC_COLS or next_fcol > F._MAX_REC_COLS:
        return _no("record-columns",
                   f"measurement channels exceed the kernel record width "
                   f"({max(next_col, next_fcol)} > {F._MAX_REC_COLS})")

    # const-norm fast path: |dr| = speed * dt replaces the per-photon norm.
    # Valid iff exactly one kinematics step precedes every scatter op (so dr
    # is always this iteration's v*dt) and every particle moves at one common
    # speed that matches each isotropic op's resample speed (scattering then
    # preserves it).
    const_speed = None
    kin_positions = [i for i, op in enumerate(ops) if op.kind == "kin"]
    # |dr| consumers: the collision probability of every scatter family plus
    # the fresnel segment-remainder computation
    scatter_positions = [i for i, op in enumerate(ops)
                         if op.kind in ("del", "iso", "hg", "rayl", "pol",
                                        "polc", "compton", "fresnel")]
    emit_positions = [i for i, op in enumerate(ops) if op.kind == "emit"]
    # dr modifiers: a reflection or an interface event folds/kinks dr, so
    # any |dr| consumer downstream of one must use the computed norm
    reflect_positions = [i for i, op in enumerate(ops)
                         if op.kind in ("reflect", "fresnel")]
    if (len(kin_positions) == 1 and scatter_positions
            and all(p > kin_positions[0] for p in scatter_positions)
            # photons emitted after kinematics carry dr=0 until the next
            # iteration; const-norm would wrongly charge them a full step
            and all(p < kin_positions[0] for p in emit_positions)
            # a reflection folds dr, so a scatter op downstream of it must
            # use the computed |dr|, not c*dt
            and not any(kin_positions[0] < q < p
                        for q in reflect_positions
                        for p in scatter_positions if q != p)
            # custom physics / field pushes change velocities arbitrarily
            and not any(op.kind in ("custom", "lorentz") for op in ops)
            # match_speed interfaces make speeds heterogeneous (c/n per
            # medium): |dr| == c*dt stops holding population-wide
            and not any(op.kind == "fresnel" and op.iface[4]
                        for op in ops)):
        speeds = []
        for o in sim._pending_objects:
            speeds.append(float(np.linalg.norm(
                np.asarray(raw_code_value(o.v), np.float64).reshape(3))))
        for b in sim._pending_bulk:
            if isinstance(b["v"], jax.Array):
                # device bulk: reduce on device, fetch two scalars
                import jax.numpy as jnp

                norms = jnp.sqrt(jnp.sum(b["v"].astype(jnp.float32) ** 2,
                                         axis=0))
                speeds.append(float(jax.device_get(jnp.min(norms))))
                speeds.append(float(jax.device_get(jnp.max(norms))))
            else:
                vv = np.asarray(b["v"], np.float64)
                norms = np.linalg.norm(vv, axis=0)
                speeds.append(float(norms.min()))
                speeds.append(float(norms.max()))
        for op in ops:  # emitted photons join the population at these speeds
            if op.kind == "emit":
                if op.emit_v is None:
                    speeds.append(op.c_val)
                else:
                    speeds.append(float(np.linalg.norm(op.emit_v)))
        if speeds:
            s0 = speeds[0]
            ok = s0 > 0 and max(abs(s - s0) for s in speeds) <= 1e-4 * s0
            for op in ops:
                if ((op.kind in ("iso", "hg", "rayl", "pol", "polc",
                                 "compton")
                     or (op.kind == "del" and op.fluor))
                        and abs(op.c_val - s0) > 1e-5 * s0):
                    ok = False
            if ok:
                const_speed = s0

    # Exit predicate classification: a declared intent (Simulation(
    # until_t=...) / exit="extinction" set .exit_mode_hint) skips the
    # empirical probe entirely — the documented fast path for predicates
    # that are impure or shaped unusually; probing is the fallback.
    hint = getattr(sim.exit, "exit_mode_hint", None)
    if hint == "t" or (hint is None and _probe_t_only(sim.exit)):
        exit_mode = "t"
    elif hint == "n0" or (hint is None and _probe_extinction(sim.exit)):
        exit_mode = "n0"
        if not any(op.kind in ("del", "absorb", "custom") for op in ops):
            # nothing can ever die: predicate never fires
            return _no("extinction-without-death",
                       "extinction exit but no step can remove photons "
                       "(no ScatterDelete/AbsorbingBoundary/custom): the "
                       "run would never terminate on the fused path")
        if any(op.kind == "emit" for op in ops):
            # post-extinction device emissions could not be rolled back by
            # record trimming; only t-exits compose with in-kernel sources
            return _no("extinction-with-emitter",
                       "extinction exit + PhotonEmitterStep: in-kernel "
                       "emissions past the extinction iteration cannot be "
                       "rolled back; use a t-based exit "
                       "(Simulation(until_t=...)) with emitters")
    else:
        return _no("exit-predicate",
                   f"exit predicate {getattr(sim.exit, '__name__', repr(sim.exit))} "
                   "is neither t-only nor extinction-shaped on host probes; "
                   "declare intent with Simulation(until_t=...) or "
                   "Simulation(exit='extinction'), or restrict the lambda "
                   "to sim.t/sim.dt or `len(sim.objects) == 0`")

    # 1024 iterations per dispatch amortizes per-chunk host/dispatch overhead
    chunk = int(sim.chunk_steps) if sim.chunk_steps else 1024
    emit_total = sum(op.emit_n for op in ops if op.kind == "emit")
    if emit_total:
        # one chunk's emissions must fit in half the arena, or emission
        # starves mid-chunk before the engine can recycle slots
        chunk = max(1, min(chunk, (state.capacity // 2) // emit_total))
    stream_every = 1
    stream_dtype = "float32"
    if next_plane:
        import math

        # kernel stream stride: the gcd of every stream source's sampling
        # period (per-photon E capture is per-iteration => 1). Ops whose
        # trace_every exceeds the kernel stride subsample rows on the host.
        periods = [m["every"] for m in rec_map if m["kind"] == "trace"]
        has_ecap = any(
            m["kind"] == "cross" and any(p >= 0 for p in m["ecap_planes"])
            for m in rec_map)
        if has_ecap:
            periods.append(1)
        stream_every = math.gcd(*periods) if periods else 1
        # bf16 stream planes (halved bytes => 2x iterations per dispatch
        # for unstrided large-N tracing): only when EVERY trace step opted
        # in AND no per-photon E capture shares the buffer (captured
        # energies keep f32 precision)
        trace_steps = [s for s in steps
                       if type(s) is TracePathMeasureStep]
        if (trace_steps and not has_ecap
                and all(getattr(s, "trace_dtype", "float32") == "bfloat16"
                        for s in trace_steps)):
            stream_dtype = "bfloat16"
        # stream planes allocate (ceil(chunk/stride), n_planes, C) elements
        # per dispatch; cap the chunk so one dispatch stays within the
        # record-buffer budget
        elem = 2 if stream_dtype == "bfloat16" else 4
        row_bytes = next_plane * state.capacity * elem
        budget = int(getattr(sim, "max_record_bytes", 256 << 20))
        chunk = max(1, min(chunk,
                           (budget // max(row_bytes, 1)) * stream_every))
        if stream_every > 1:
            # full chunks must be a multiple of every sampling period so the
            # sampled iterations stay global multiples of trace_every across
            # chunk boundaries (k restarts at 0 each chunk)
            period_lcm = math.lcm(*periods)
            if chunk >= period_lcm:
                chunk = (chunk // period_lcm) * period_lcm
            else:  # chunk pinned below one period (emitter cap / user chunk):
                stream_every = 1  # sample every iteration, subsample on host
                # ...which voids the stride-scaled cap above: re-apply the
                # budget at one stream row per iteration
                chunk = max(1, min(chunk, budget // max(row_bytes, 1)))
    plan = F.FusedPlan(
        ops=ops, n_rec_cols=next_col, chunk=chunk,
        tile_rows=(getattr(sim, "fused_tile_rows", None)
                   or F.KERNEL_TILE_ROWS),
        species=species,
        extras=tuple(extra_names),
        extras_writeback=(tuple(nm for nm in ("stokes", "pol_ref")
                                if nm in pol_wb)
                          + tuple(dict.fromkeys(
                              nm for nm in user_wb
                              if nm not in pol_wb))),
        const_norm_speed=const_speed,
        packed_angles=True,
        fast_trig=True,
        n_stream=next_plane,
        stream_every=stream_every,
        stream_dtype=stream_dtype,
    )
    builder, why = F.choose_builder(plan)
    plan = dataclasses.replace(plan, builder=builder)
    provider = FusedProvider(sim, plan, rec_map, dt_fn, update_before_kin,
                             measure_after_update, sim.exit, exit_mode)
    provider.builder_reason = why
    return provider
