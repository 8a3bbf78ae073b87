"""Simulation engine: the reference's threaded step loop, rebuilt as jit-compiled scans.

Reference behavior reproduced (``physicl/__init__.py:293-541``):

* ``Simulation(**kwargs)`` with ``bounds``, ``exit`` predicate, ``state_fn``,
  ``state_need_lock``; ``add_step(idx, step)`` with unique indices but
  **insertion-order execution** (the reference iterates ``dict.items()``, not
  sorted indices — ``physicl/__init__.py:514``, demonstrated by
  ``examples/trace_ex.py:9-12``);
* ``add_obj``/``add_objs``/``remove_obj``/``remove_step``; ``start()``/``join()``
  threading surface; lock-guarded ``get_state()`` polling; ``sim.ts`` time log;
  per-step ``terminate`` with CSV output for measure steps.

Design (not a translation):

* the ``while not exit: for step: step.run(sim)`` interpreter loop
  (``physicl/__init__.py:512-516``) becomes a ``lax.scan`` over a
  structure-of-arrays :class:`~physicl_tpu.state.SimState` carry, jit-compiled
  once and dispatched in chunks of K iterations so the host can poll state;
* steps are pure traced transforms ``apply(state, ctx) -> state`` composed into
  one fused scan body (XLA fuses the whole per-iteration pipeline);
* the exit predicate runs **on device** when traceable (checked before every
  iteration, exactly like the reference loop); untraceable host predicates
  (e.g. ``lambda x: len(x.objects) == 0``) fall back to single-iteration chunks
  evaluated on host — exact, but slower (documented);
* measurement data accumulates as scan outputs fetched once per chunk, instead
  of per-iteration host round trips.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.state import SimState, OBJ_GENERIC, OBJ_PHOTON, pad_capacity
from physicl_tpu.units import Measurement, raw_code_value

__all__ = [
    "Step",
    "UpdateTimeStep",
    "MeasureStep",
    "ElementwiseStep",
    "ReduceMeasureStep",
    "ParticleView",
    "Object",
    "Simulation",
    "IndexException",
    "StepContext",
]


class IndexException(Exception):
    """Raised when adding a step at an occupied index (defined here; the
    reference raises an *undefined* name at physicl/__init__.py:441)."""


class _HostOnlyPredicate(Exception):
    """Signals during probing that an exit/state predicate needs host values."""


# ---------------------------------------------------------------------------
# Step protocol
# ---------------------------------------------------------------------------


class StepContext:
    """Per-iteration context handed to ``Step.apply``.

    Provides a deterministic per-iteration PRNG-key stream and a record sink for
    measurement outputs (collected as scan outputs, fetched per chunk).
    """

    def __init__(self, iter_key: jax.Array, sim: "Simulation"):
        self._iter_key = iter_key
        self._fold = 0
        self.sim = sim
        self.records: Dict[str, jax.Array] = {}

    def next_key(self) -> jax.Array:
        self._fold += 1
        return jax.random.fold_in(self._iter_key, self._fold)

    def record(self, step: "Step", name: str, value: jax.Array) -> None:
        self.records[f"{step._step_uid}/{name}"] = value


class Step:
    """Base step. Subclasses implement the traced ``apply`` transform.

    Lifecycle (host side): ``setup(sim)`` once before compilation;
    ``collect(sim, records)`` after each chunk with this step's recorded
    arrays (trimmed to valid iterations); ``terminate(sim)`` once at exit —
    mirroring the reference's ``run``/``terminate`` lifecycle
    (physicl/__init__.py:293-322) with the per-iteration work moved on-device.
    """

    _step_uid: str = ""

    def setup(self, sim: "Simulation") -> None:
        pass

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        return state

    def collect(self, sim: "Simulation", records: Dict[str, np.ndarray]) -> None:
        pass

    def terminate(self, sim: "Simulation") -> None:
        pass


class UpdateTimeStep(Step):
    """Advances the clock: ``dt = fn(sim); t += dt`` and logs ``sim.ts``
    (reference: physicl/__init__.py:324-343). ``fn`` receives a traced view with
    ``.t``, ``.dt``, ``.n_objects`` and must return the time increment."""

    def __init__(self, fn: Callable[[Any], Any]):
        super().__init__()
        self.fn = fn

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        dt_raw = self.fn(_TracedView(state, ctx.sim))
        dt = jnp.asarray(raw_code_value(dt_raw) if isinstance(dt_raw, Measurement)
                         else dt_raw, state.t.dtype)
        # Kahan-compensated accumulation: device scalars are f32, and a bare
        # ``t += dt`` drifts by O(n*eps) — enough to miss ``t >= T`` exits by
        # thousands of iterations at 1e6 steps of tiny dt. The compensation
        # scalar keeps t within ~1 ulp of the exact sum at 3 extra scalar
        # flops per iteration (reference keeps f64 t on the host,
        # physicl/__init__.py:341-343).
        comp = jnp.asarray(state.t_comp, state.t.dtype)
        y = dt - comp
        t = state.t + y
        comp = (t - state.t) - y
        ctx.record(self, "ts", t)
        return state.replace(t=t, dt=dt, t_comp=comp)

    def collect(self, sim: "Simulation", records: Dict[str, np.ndarray]) -> None:
        sim.ts.extend(float(x) for x in records["ts"])


class ParticleView:
    """Per-particle elementwise view handed to :class:`ElementwiseStep`
    functions: component arrays ``rx..rz, drx..drz, vx..vz, dvx..dvz, E``,
    the statistical weight ``w``, the boolean ``alive`` mask, scalars
    ``t``/``dt``, and ``uniform()`` for per-particle U[0,1) draws. Shapes
    are opaque (the generic path passes ``(C,)`` vectors, the fused kernel
    ``(rows, 128)`` tiles) — write elementwise jnp code and it runs
    identically on both.

    Steps constructed with ``extras=("name", ...)`` additionally expose
    ``p.extras["name"]`` — the per-particle aux plane of that name: one
    array for a scalar ``(C,)`` plane, a tuple of component arrays for a
    3-row plane (e.g. ``"stokes"``)."""

    _FIELDS = ("rx", "ry", "rz", "drx", "dry", "drz",
               "vx", "vy", "vz", "dvx", "dvy", "dvz", "E", "alive", "w")

    def __init__(self, fields: Dict[str, Any], t, dt, uniform, extras=None):
        for k, v in fields.items():
            setattr(self, k, v)
        self.t = t
        self.dt = dt
        self.uniform = uniform
        self.extras = extras or {}


_MISSING_EXTRAS_MSG = (
    "step declares extras={names} but the population carries no '{name}' "
    "plane: attach it to the initial population (Object kwargs, bulk "
    "dict 'extras', or polarization.polarized_photon_state for Stokes "
    "planes)")


def _check_extras_decl(extras, who: str) -> tuple:
    extras = tuple(extras)
    if not all(isinstance(n, str) and n for n in extras):
        raise TypeError(f"{who} extras= must be a tuple of plane names, "
                        f"got {extras!r}")
    return extras


def _state_particle_view(state: "SimState", ctx: "StepContext",
                         extras_decl=()) -> ParticleView:
    """Generic-path ParticleView over the full SoA state (the fused kernel
    builds the same view over one tile in ops/fused.py)."""
    comp = {"rx": 0, "ry": 1, "rz": 2}
    fields = {}
    for name in ParticleView._FIELDS:
        if name == "E":
            fields[name] = state.E
        elif name == "alive":
            fields[name] = state.alive
        elif name == "w":
            fields[name] = state.w
        else:
            base = {"r": "r", "dr": "dr", "v": "v", "dv": "dv"}[name[:-1]]
            fields[name] = getattr(state, base)[comp["r" + name[-1]]]
    key = ctx.next_key()
    fold = [0]

    def uniform():
        fold[0] += 1
        return jax.random.uniform(
            jax.random.fold_in(key, fold[0]),
            state.E.shape, state.E.dtype)

    ex = {}
    for name in extras_decl:
        if name not in state.extras:
            raise ValueError(_MISSING_EXTRAS_MSG.format(
                names=tuple(extras_decl), name=name))
        arr = state.extras[name]
        ex[name] = (arr if arr.ndim == 1
                    else tuple(arr[i] for i in range(arr.shape[0])))
    return ParticleView(fields, state.t, state.dt, uniform, extras=ex)


class ElementwiseStep(Step):
    """User-defined per-particle physics that KEEPS the fused fast path.

    ``fn(p: ParticleView) -> dict`` returns updated fields by name (any
    subset of ``ParticleView._FIELDS``). The explicit contract that makes
    this fusable — unlike :class:`physicl_tpu.kernels.KernelStep`, which has
    full SimState access and always takes the generic path:

    * strictly elementwise over the particle axis (no reductions, no
      gathers, no cross-particle communication — inside the fused kernel the
      function sees one tile, so a reduction would silently be
      tile-local). This claim is VERIFIED at plan time by behavioral probes
      (``ops/pipeline._probe_particle_fn``: row-permutation,
      one-particle-perturbation and capacity-doubling checks on a tiny CPU
      view); a violating fn refuses to the generic scan with a structured
      ``elementwise-not-elementwise`` reason instead of silently computing
      tile-local physics;
    * only the transport fields above, plus aux planes declared with
      ``extras=("name", ...)`` (exposed as ``p.extras["name"]`` — a scalar
      plane or a 3-tuple of component planes). Planes additionally listed
      in ``extras_write=("name", ...)`` may appear in the returned update
      dict (scalar plane: one array; 3-row plane: a 3-tuple of component
      arrays) and are WRITTEN back on both execution paths — per-photon
      dose, path length, spin, any user-tracked quantity stays inside the
      fused kernel (the machinery the polarization planes proved out);
    * randomness only via ``p.uniform()`` (reproducible counter streams on
      the generic path, hardware PRNG in-kernel — statistically identical);
    * a returned ``alive`` can only clear (it is AND-ed with the current
      mask); spawning needs :class:`physicl_tpu.light.PhotonEmitterStep`.

    Example — a time-dependent absorber accumulating per-photon dose::

        def decay(p):
            u = p.uniform()
            rate = 0.1 * jnp.exp(-p.t)
            hit = u < rate * p.dt
            return {"alive": ~hit,
                    "dose": p.extras["dose"] + hit * p.E}

        sim.add_step(3, ElementwiseStep(decay, extras_write=("dose",)))
    """

    def __init__(self, fn: Callable[[ParticleView], Dict[str, Any]],
                 extras: tuple = (), extras_write: tuple = ()):
        self.fn = fn
        self.extras_write = _check_extras_decl(extras_write,
                                               "ElementwiseStep")
        # writable planes are implicitly readable (one declaration each)
        self.extras = tuple(dict.fromkeys(
            _check_extras_decl(extras, "ElementwiseStep")
            + self.extras_write))

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        upd = self.fn(_state_particle_view(state, ctx, self.extras))
        bad = set(upd) - set(ParticleView._FIELDS) - set(self.extras_write)
        if bad:
            raise ValueError(
                f"ElementwiseStep returned unknown fields {bad} (transport "
                f"fields or extras_write={self.extras_write} only)")

        def vec(base):
            names = [base + ax for ax in "xyz"]
            if not any(n in upd for n in names):
                return getattr(state, base)
            cur = getattr(state, base)
            return jnp.stack([
                jnp.asarray(upd.get(n, cur[i]), cur.dtype)
                for i, n in enumerate(names)])

        out = state.replace(r=vec("r"), dr=vec("dr"), v=vec("v"),
                            dv=vec("dv"))
        if "E" in upd:
            out = out.replace(E=jnp.asarray(upd["E"], state.E.dtype))
        if "w" in upd:
            out = out.replace(w=jnp.asarray(upd["w"], state.w.dtype))
        if "alive" in upd:
            out = out.replace(alive=state.alive & jnp.asarray(upd["alive"],
                                                              jnp.bool_))
        written = [n for n in self.extras_write if n in upd]
        if written:
            new_extras = dict(state.extras)
            for name in written:
                cur = state.extras[name]
                val = upd[name]
                if cur.ndim == 1:
                    new_extras[name] = jnp.asarray(val, cur.dtype)
                else:
                    comps = tuple(val)
                    if len(comps) != cur.shape[0]:
                        raise ValueError(
                            f"extras_write plane {name!r} has "
                            f"{cur.shape[0]} rows; update returned "
                            f"{len(comps)} components")
                    new_extras[name] = jnp.stack(
                        [jnp.asarray(v, cur.dtype) for v in comps])
            out = out.replace(extras=new_extras)
        return out


class MeasureStep(Step):
    """Accumulates ``self.data`` rows; ``terminate`` writes CSV to ``out_fn``
    (reference: physicl/__init__.py:345-378, minus the interactive
    retry-forever loop and the broken dict branch — SURVEY quirk list)."""

    def __init__(self, out_fn: Optional[str] = None):
        super().__init__()
        self.out_fn = out_fn
        self.data: List[Any] = []

    def terminate(self, sim: "Simulation") -> None:
        if self.out_fn is None:
            return
        from physicl_tpu.utils.io import write_rows

        if isinstance(self.data, dict):
            # the reference's dict branch intended `k, v` rows (its
            # `for k, v in self.data` at physicl/__init__.py:374 is missing
            # .items() and raises); keys must not be dropped
            rows = [[k, *v] if isinstance(v, (list, tuple, np.ndarray))
                    else [k, v] for k, v in self.data.items()]
        else:
            rows = self.data
        write_rows(self.out_fn, rows)


class ReduceMeasureStep(MeasureStep):
    """User-defined per-particle measurement that KEEPS the fused fast path —
    the measurement counterpart of :class:`ElementwiseStep`.

    ``fn(p: ParticleView) -> dict`` returns named per-particle contribution
    arrays; each iteration records their sums over ALIVE particles. ``data``
    rows are ``[t(, n), sum_0, sum_1, ...]`` in ``outputs`` order, with CSV
    via ``out_fn`` like every MeasureStep. Output names are declared up
    front so the fused prover can allocate record channels without probing
    user code.

    Same elementwise contract as ElementwiseStep (read-only: the returned
    arrays are contributions, not field updates), including read-only aux
    planes via ``extras=("name", ...)``; reductions cross shards as one
    psum on mesh runs. Example — radial energy flux and second moment::

        def moments(p):
            r2 = p.rx**2 + p.ry**2 + p.rz**2
            return {"E_total": p.E, "r2": r2}

        sim.add_step(4, ReduceMeasureStep(None, moments,
                                          outputs=("E_total", "r2")))
    """

    def __init__(self, out_fn=None, fn: Callable[[ParticleView],
                                                 Dict[str, Any]] = None,
                 outputs=(), measure_n: bool = False, extras: tuple = ()):
        super().__init__(out_fn)
        if fn is None or not outputs:
            raise ValueError(
                "ReduceMeasureStep needs fn and a non-empty outputs tuple")
        self.fn = fn
        self.extras = _check_extras_decl(extras, "ReduceMeasureStep")
        self.outputs = tuple(outputs)
        if {"t", "n"} & set(self.outputs):
            raise ValueError(
                "'t' and 'n' are reserved record names; rename the output")
        self.measure_n = measure_n

    def _contributions(self, view: ParticleView) -> Dict[str, Any]:
        contrib = self.fn(view)
        missing = set(self.outputs) - set(contrib)
        if missing:
            raise ValueError(
                f"ReduceMeasureStep fn did not return declared outputs "
                f"{sorted(missing)}")
        return contrib

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        contrib = self._contributions(
            _state_particle_view(state, ctx, self.extras))
        for name in self.outputs:
            val = jnp.asarray(contrib[name], jnp.float32)
            ctx.record(self, name, jnp.sum(
                jnp.where(state.alive, val, jnp.float32(0.0))))
        return state

    def collect(self, sim: "Simulation", records) -> None:
        for i in range(len(records["t"])):
            row = [float(records["t"][i])]
            if self.measure_n:
                row.append(int(records["n"][i]))
            row.extend(float(records[name][i]) for name in self.outputs)
            self.data.append(row)


# ---------------------------------------------------------------------------
# Host-facing objects
# ---------------------------------------------------------------------------


class Object:
    """Generic particle (host-side constructor; becomes one SoA slot).

    Same attribute surface as the reference (physicl/__init__.py:381-397):
    ``r``, ``dr``, ``v``, ``dv``, ``a`` as 3-vector Measurements plus arbitrary
    kwargs. (``dv`` carries velocity units here; the reference's acceleration
    units at __init__.py:392 are a documented quirk we do not replicate.)
    """

    _obj_type_code = OBJ_GENERIC

    def __init__(self, **kwargs):
        self.r = Measurement([0.0] * 3, "m**1")
        self.dr = Measurement([0.0] * 3, "m**1")
        self.dv = Measurement([0.0] * 3, "m**1 s**-1")
        self.v = Measurement([0.0] * 3, "m**1 s**-1")
        self.a = Measurement([0.0] * 3, "m**1 s**-2")
        for attr, val in kwargs.items():
            setattr(self, attr, val)


# ---------------------------------------------------------------------------
# Traced / host views handed to user lambdas (exit, state_fn, dt fn)
# ---------------------------------------------------------------------------


class _TracedObjectsProxy:
    """Stands in for ``sim.objects`` inside traced predicates. ``len()`` cannot
    produce a traced value, so predicates that call it are detected at probe
    time and re-routed to the host path."""

    def __init__(self, count):
        self.count = count

    def __len__(self):
        raise _HostOnlyPredicate("len(sim.objects) is not traceable")


class _TracedView:
    """Traced stand-in for the ``Simulation`` passed to user lambdas on device."""

    def __init__(self, state: SimState, sim: "Simulation"):
        self._state = state
        self.bounds = sim.bounds

    @property
    def t(self):
        return self._state.t

    @property
    def dt(self):
        return self._state.dt

    @property
    def n_objects(self):
        return self._state.n_alive

    @property
    def objects(self):
        return _TracedObjectsProxy(self._state.n_alive)


class _PendingPopulation:
    """Pre-run ``sim.objects`` when bulk photon populations are queued:
    ``len()`` covers objects + bulks; iteration materializes bulk entries as
    PhotonObjects on demand (explicitly expensive at large N — use
    ``sim._pending_bulk`` arrays for bulk analysis)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def __len__(self):
        return len(self._sim._pending_objects) + sum(
            int(b["n"]) for b in self._sim._pending_bulk)

    def _materialize(self):
        from physicl_tpu.light import PhotonObject

        out = list(self._sim._pending_objects)
        for b in self._sim._pending_bulk:
            E = np.asarray(b["E"])
            v = np.asarray(b["v"])
            r = np.asarray(b["r"])
            for i in range(int(b["n"])):
                o = PhotonObject.__new__(PhotonObject)
                # bulk arrays store code-unit values (generate_photon_state
                # applies raw_code_value): wrap without re-scaling
                o.r = Measurement.from_code(r[:, i], "m**1")
                o.dr = Measurement.from_code([0.0] * 3, "m**1")
                o.v = Measurement.from_code(v[:, i], "m**1 s**-1")
                o.dv = Measurement.from_code([0.0] * 3, "m**1 s**-1")
                o.a = Measurement.from_code([0.0] * 3, "m**1 s**-2")
                o.E = Measurement.from_code(float(E[i]), "J**1")
                if "w" in b:
                    o.w = float(np.asarray(b["w"])[i])
                out.append(o)
        return out

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]


class _HostObjectsProxy:
    """``sim.objects`` during/after a run: len() reflects the alive count;
    iteration/indexing materializes host Object instances on demand."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def __len__(self):
        return self._sim._n_alive_host()

    def __iter__(self):
        return iter(self._sim._materialize_objects())

    def __getitem__(self, i):
        return self._sim._materialize_objects()[i]


class _HostView:
    """Host stand-in for the ``Simulation`` in host-mode exit predicates.

    ``objects`` reports the live count cheaply; iterating/indexing it
    materializes real host objects from device state (correct but slow —
    documented cost of host-mode predicates, which run once per iteration).
    """

    def __init__(self, sim: "Simulation", t: float, dt: float, n_alive: int):
        self._sim = sim
        self.bounds = sim.bounds
        self.t = t
        self.dt = dt
        self.n_objects = n_alive
        self.objects = _LazyObjects(sim, n_alive)


class _LazyObjects:
    def __init__(self, sim, n):
        self._sim = sim
        self._n = n

    def __len__(self):
        return self._n

    def __iter__(self):
        return iter(self._sim._materialize_objects())

    def __getitem__(self, i):
        return self._sim._materialize_objects()[i]


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------


_record_budget: Optional[int] = None


def _default_record_budget() -> int:
    """Auto stream-budget: HBM/8 clamped to [256 MB, 2 GB].

    Resolved once per process from the default device's memory_stats()
    where the backend reports it (GPUs do), else the 2 GB cap (the CPU;
    host RAM is not the constraint there).
    """
    global _record_budget
    if _record_budget is None:
        limit = 0
        try:
            d = jax.devices()[0]
            stats = d.memory_stats()
            if stats:
                limit = int(stats.get("bytes_limit") or 0)
        except Exception:
            pass
        _record_budget = (max(256 << 20, min(2 << 30, limit // 8))
                          if limit else 2 << 30)
    return _record_budget


def _default_exit(view) -> jax.Array:
    return view.n_objects == 0


class ExtinctionExit:
    """Declared 'run until no objects remain' exit (``exit="extinction"``).

    Functionally the reference-idiomatic ``lambda x: len(x.objects) == 0``
    (physicl/__init__.py:414), but carries an explicit intent marker so the
    planner never has to probe the predicate empirically — the documented
    fast path for the fused pipeline and chunked generic scans.
    """

    exit_mode_hint = "n0"

    def __call__(self, view):
        return view.n_objects == 0

    def __repr__(self):
        return "ExtinctionExit()"


class UntilT:
    """Declared 'run until sim.t >= T' exit (``Simulation(until_t=T)``).

    Equivalent to ``lambda c: c.t >= T`` but marked as t-only so the
    planner precomputes the exact exit iteration from the host-replayed
    time schedule without probing user code.
    """

    exit_mode_hint = "t"

    def __init__(self, T):
        self.T = float(raw_code_value(T))

    def __call__(self, view):
        return view.t >= self.T

    def __repr__(self):
        return f"UntilT({self.T!r})"


@dataclasses.dataclass
class PlanReport:
    """Why the engine chose its execution strategy (``sim.explain_plan()``).

    ``mode``: ``"fused"`` (multi-iteration fused chunk), ``"generic"``
    (chunked jitted scan), or ``"host-exact"`` (chunk=1, one host round trip
    per iteration — up to ~1000x slower; the exit predicate could not be
    classified). ``refusals`` lists every (code, detail) reason the fused
    prover declined; empty when fused or when fusion wasn't attempted.
    """

    mode: str
    chunk: int
    fuse_setting: str
    allow_fuse: bool
    exit_tier: str
    refusals: List[tuple] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    # fused mode: which chunk builder compiles the pipeline ("triton" |
    # "xla", ops/fused.choose_builder) and why
    builder: str = ""
    builder_reason: str = ""

    def describe(self) -> str:
        lines = [f"execution mode: {self.mode} "
                 f"(chunk={self.chunk} iterations/dispatch)",
                 f"exit handling: {self.exit_tier}"]
        if self.mode == "fused":
            lines.append(f"fused chunk builder: {self.builder} — "
                         f"{self.builder_reason}")
        if self.fuse_setting != "auto":
            lines.append(f"fusion not attempted: Simulation(fuse="
                         f"{self.fuse_setting!r})")
        elif not self.allow_fuse:
            lines.append("fusion disabled for the rest of the run: a mid-run "
                         "injection broke the fused plan's proven invariants")
        for code, detail in self.refusals:
            lines.append(f"fused pipeline refused [{code}]: {detail}")
        if self.mode == "host-exact":
            lines.append(
                "host-exact mode checks the exit predicate on the host every "
                "iteration; declare intent with Simulation(until_t=...) or "
                "Simulation(exit='extinction'), or restrict the predicate to "
                "sim.t/sim.dt or `len(sim.objects) == 0` to restore chunked "
                "execution")
        lines.extend(self.notes)
        return "\n".join(lines)


class Simulation(threading.Thread):
    """Threaded simulation driver (API parity with physicl/__init__.py:400-541).

    Extra knobs (all optional):

    * ``chunk_steps``: iterations per device dispatch (auto-sized by default);
    * ``seed``: PRNG seed for all stochastic steps (counter-based, reproducible);
    * ``dtype``: state dtype (default float32; the statistical
      tolerances of the physics are far looser than f32 precision);
    * ``capacity``: particle-buffer capacity (defaults to padded object count);
    * ``jit_on``: disable to run the same code eagerly (debugging oracle; the
      ``cl_on`` kwarg is accepted as a compatibility alias and ignored).
    """

    def __init__(self, **kwargs):
        threading.Thread.__init__(self)
        self.bounds = np.zeros(3)
        self.cl_on = True          # compat alias, unused (no OpenCL here)
        self.jit_on = True
        self.exit = _default_exit
        self.state_fn = lambda x: {
            "objects": len(x.objects),
            "t": x.t,
            "dt": x.dt,
            "run_time": time.time() - x.start_time,
        }
        self.state_need_lock = False
        self.chunk_steps: Optional[int] = None
        self.seed = 0
        self.dtype = jnp.float32
        self.capacity: Optional[int] = None
        # per-dispatch record/stream buffer budget: larger => more iterations
        # per chunk on stream-plane workloads (path tracing), amortizing the
        # fixed per-dispatch cost; the pipelined fused loop holds at most two
        # of these in HBM at once (plus up to device_hold_bytes retained by
        # the trace step before spilling to host RAM). Default None = auto:
        # device memory/8 clamped to [256 MB, 2 GB], resolved lazily from
        # the default device (2 GB on an 80 GB GPU; a small device gets
        # less, which the flat 2 GB default could OOM). Assign an int to
        # override.
        self._max_record_bytes: Optional[int] = None
        self.fuse = "auto"  # "auto" | "off": use the fused pipeline
        # generic-path PRNG implementation for jax.random (None = JAX's
        # default, threefry); e.g. "rbg" to trade stream portability for
        # a cheaper generator
        self.prng_impl = None
        # Triton kernel block: rows of 128 photons per program (None = the
        # tuned default, ops/fused.KERNEL_TILE_ROWS). The builder halves it
        # until it divides the buffer
        self.fused_tile_rows = None
        # outstanding fused chunks the dispatch loop keeps in flight beyond
        # the one being harvested (see _drive_fused); 1 disables the deeper
        # overlap. Stream-plane (trace) plans are capped at 2 in-flight
        # regardless — each chunk holds up to max_record_bytes of device
        # memory
        self.fused_pipeline_depth = 4
        self.mesh = None  # jax.sharding.Mesh: shard the particle axis
        # compact + shrink capacity when <1/4 of the buffer is alive
        # (disabled automatically when a step needs stable particle slots)
        self.auto_shrink = True
        # spatial_sort=K (chunks): every K chunk dispatches, reorder the
        # population by flat voxel index of the run's first voxel_density
        # medium (ops/compaction.make_spatial_sort), so each kernel block
        # gathers from a narrow band of the table. Costs slot identity
        # (refused with a warning when a step needs stable ids; mid-run
        # remove_obj unavailable) and reassigns per-slot RNG streams
        # (statistically identical, not bitwise vs. unsorted). 0 = off.
        self.spatial_sort = 0
        self._sort_fn = None
        self._sort_every = 1
        self._sort_tick = 0
        # declared exit intent (documented fast path; skips predicate probing)
        self.until_t = None
        for attr, val in kwargs.items():
            setattr(self, attr, val)
        if self.until_t is not None:
            if self.exit is not _default_exit:
                raise ValueError(
                    "pass either until_t=... or exit=..., not both")
            self.exit = UntilT(self.until_t)
        if isinstance(self.exit, str):
            if self.exit != "extinction":
                raise ValueError(
                    f"unknown exit mode {self.exit!r}; string form accepts "
                    "'extinction' (run until no objects remain)")
            self.exit = ExtinctionExit()

        self.plan_report: Optional[PlanReport] = None
        self.chunk_used: Optional[int] = None
        self._warned_fallback = False
        self.dt = Measurement(np.double(0), "s**1")
        self.t = Measurement(np.double(0), "s**1")
        self._pending_objects: List[Object] = []
        self._pending_bulk: List[Dict[str, Any]] = []
        self._pending_inject: List = []
        self._pending_remove: List[int] = []
        self._inject_lock = threading.Lock()
        self._slot_of: Dict[int, int] = {}  # id(obj) -> slot
        self._hwm = 0  # high-water slot mark (injections append here)
        self.steps: Dict[int, Step] = {}
        self._state_lock = threading.Lock()
        self.running = False
        self.start_time = 0.0
        self.run_time = 0.0
        self.ts: List[float] = []
        self.sim_state: Optional[SimState] = None
        self._restored = None
        self._objects_cache: Optional[List[Object]] = None
        self._host_t = 0.0
        self._host_dt = 0.0
        self._host_n_alive = 0
        self._initial_count = 0

    @property
    def max_record_bytes(self) -> int:
        """Per-dispatch stream/record HBM budget. Auto (unless assigned):
        device HBM/8 clamped to [256 MB, 2 GB] — two budgets are in flight
        at once and the arena + packed state need the rest."""
        if self._max_record_bytes is not None:
            return self._max_record_bytes
        return _default_record_budget()

    @max_record_bytes.setter
    def max_record_bytes(self, v: int) -> None:
        self._max_record_bytes = int(v)

    # -- population management -------------------------------------------------

    @property
    def objects(self):
        if self.sim_state is None and not self.running:
            if not self._pending_bulk:
                return self._pending_objects
            return _PendingPopulation(self)
        return _HostObjectsProxy(self)

    def add_obj(self, obj: Object) -> None:
        """Add an object. During a run (reference parity: the threaded loop
        allows it, physicl/__init__.py:443-447) the object is injected at the
        next chunk boundary (with a mesh: written into the sharded state and
        re-placed across the mesh — a host-side device_put per boundary)."""
        if self.running:
            with self._inject_lock:
                self._pending_inject.append(("obj", obj))
            return
        self._pending_objects.append(obj)
        self._objects_cache = None

    def add_objs(self, objs) -> None:
        for o in objs:
            self.add_obj(o)

    def add_photons(self, bulk: Dict[str, Any]) -> None:
        """Add a bulk photon population built by
        :func:`physicl_tpu.light.generate_photon_state` — the fast path for
        large N that never creates per-particle Python objects. Mid-run
        additions inject at the next chunk boundary (mesh runs included)."""
        if self.running:
            with self._inject_lock:
                self._pending_inject.append(("bulk", bulk))
            return
        self._pending_bulk.append(bulk)
        self._objects_cache = None

    def add_particles(self, bulk: Dict[str, Any]) -> None:
        """Add any bulk population dict — photons
        (:func:`physicl_tpu.light.generate_photon_state`) or massive/charged
        particles (:func:`physicl_tpu.newton.generate_particle_state`); the
        ``otype`` key carries the species. Alias of :meth:`add_photons`."""
        self.add_photons(bulk)

    def remove_obj(self, obj: Object) -> None:
        """Remove an object. During a run (reference parity:
        physicl/__init__.py:455-459) the object's slot is cleared at the next
        chunk boundary; only objects added via ``add_obj`` have an identity
        (bulk photons do not), and removal is unavailable when compaction may
        move slots (auto_shrink or a continuous source active)."""
        if self.running:
            if not self._slots_stable:
                raise RuntimeError(
                    "Mid-run removal needs stable slots: disable auto_shrink "
                    "and continuous sources, or remove before start().")
            slot = self._slot_of.get(id(obj))
            if slot is None:
                raise ValueError("Object was not added via add_obj().")
            with self._inject_lock:
                self._pending_remove.append(slot)
            return
        self._pending_objects.remove(obj)
        self._objects_cache = None

    def add_step(self, idx: int, step: Step) -> None:
        if idx in self.steps:
            raise IndexException("Cannot add a step to an existing index.")
        self.steps[idx] = step

    def remove_step(self, idx: int) -> None:
        if self.running:
            raise RuntimeError("Cannot remove a Step while the simulation is running.")
        self.steps.pop(idx)

    # -- device info (replaces get_device_info/set_dev OpenCL plumbing) --------

    @staticmethod
    def get_device_info() -> Dict[str, Any]:
        """Enumerate JAX devices (replaces the OpenCL platform walk at
        physicl/__init__.py:470-499)."""
        res: Dict[str, Any] = {}
        for d in jax.devices():
            info = {
                "platform": d.platform,
                "id": d.id,
                "process_index": d.process_index,
                "device_kind": d.device_kind,
            }
            try:  # HBM usage where the backend reports it
                stats = d.memory_stats()
                if stats:
                    info["bytes_in_use"] = stats.get("bytes_in_use")
                    info["bytes_limit"] = stats.get("bytes_limit")
            except Exception:
                pass
            res[str(d)] = info
        return res

    @staticmethod
    def set_dev(device_id: int) -> None:
        """Select default device by index (replaces PYOPENCL_CTX selection)."""
        jax.config.update("jax_default_device", jax.devices()[device_id])

    # -- checkpoint / resume (no reference counterpart; SURVEY.md §5) -----------

    def save_checkpoint(self, path: str) -> None:
        """Snapshot full simulation state to an .npz file."""
        from physicl_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(self, path)

    def restore_checkpoint(self, path: str) -> None:
        """Resume from a snapshot: the next ``start()`` continues from it
        instead of building state from added objects."""
        from physicl_tpu.utils.checkpoint import load_checkpoint

        if self.running:
            raise RuntimeError("Cannot restore while the simulation is running.")
        state, meta = load_checkpoint(path)
        self._restored = (state, meta)
        self._objects_cache = None

    # -- state polling -----------------------------------------------------------

    def get_state(self):
        if self.state_need_lock:
            with self._state_lock:
                return self.state_fn(self)
        return self.state_fn(self)

    def _n_alive_host(self) -> int:
        return int(self._host_n_alive)

    def _materialize_objects(self) -> List[Object]:
        """Download SoA state and rebuild host Object instances (alive only)."""
        if self._objects_cache is not None:
            return self._objects_cache
        st = self.sim_state
        if st is None:
            return self._pending_objects
        with self._state_lock:
            host = jax.device_get(
                {"r": st.r, "dr": st.dr, "v": st.v, "dv": st.dv, "a": st.a,
                 "E": st.E, "alive": st.alive, "otype": st.otype,
                 "w": st.w, "extras": dict(st.extras)}
            )
        out: List[Object] = []
        from physicl_tpu.light import PhotonObject  # local import, avoids cycle
        for i in np.nonzero(host["alive"])[0]:
            if host["otype"][i] == OBJ_PHOTON:
                o = PhotonObject.__new__(PhotonObject)
            else:
                o = Object.__new__(Object)
            # Device state is already in code units: wrap with from_code so a
            # non-unit set_code_scale is not applied a second time.
            o.r = Measurement.from_code(host["r"][:, i], "m**1")
            o.dr = Measurement.from_code(host["dr"][:, i], "m**1")
            o.v = Measurement.from_code(host["v"][:, i], "m**1 s**-1")
            o.dv = Measurement.from_code(host["dv"][:, i], "m**1 s**-1")
            o.a = Measurement.from_code(host["a"][:, i], "m**1 s**-2")
            o.E = Measurement.from_code(float(host["E"][i]), "J**1")
            o.w = float(host["w"][i])
            for name, arr in host["extras"].items():
                setattr(o, name,
                        arr[..., i] if arr.ndim == 2 else float(arr[i]))
            out.append(o)
        if not self.running:
            self._objects_cache = out
        return out

    # -- mid-run injection --------------------------------------------------------

    def _inject_into_state(self, state: SimState, items):
        """Write queued objects/bulks into slots [hwm, hwm+k) — contiguous
        dynamic_update_slice per field; grows capacity when needed."""
        from jax import lax

        objs = [x for kind, x in items if kind == "obj"]
        bulks = [x for kind, x in items if kind == "bulk"]
        k = len(objs) + sum(int(b["n"]) for b in bulks)
        if k == 0:
            return state, 0
        from physicl_tpu.parallel.distributed import mesh_spans_processes

        spans = mesh_spans_processes(self.mesh)
        if spans and not getattr(self, "divergence_guard", True):
            raise NotImplementedError(
                "Mid-run injection on a multi-process mesh requires the "
                "divergence guard: its consensus gating is what guarantees "
                "every process applies identical edits at the same chunk "
                "boundary (the update below is a global SPMD op that must "
                "execute in lockstep pod-wide). Re-enable "
                "Simulation(divergence_guard=True) or populate before "
                "start().")
        sub = SimState.from_population(objs, bulks, dtype=self.dtype)
        if spans:
            # the new rows as host values: each process feeds the identical
            # replicated operand into the global sharded update ops below
            # (a single-process device sub would pin a conflicting layout)
            sub = jax.device_get(sub)
        # device emitters may have advanced the spawn mark past the host view
        hwm = max(self._hwm, int(jax.device_get(state.n_spawned)))
        cap = state.capacity

        if hwm + k > cap:
            new_cap = pad_capacity(hwm + k)
            if self.mesh is not None:
                # capacity must stay divisible into tile-aligned shards
                unit = pad_capacity(1) * int(self.mesh.devices.size)
                new_cap = max(unit, ((new_cap + unit - 1) // unit) * unit)

            def grow(x):
                if x.ndim == 0 or x.shape[-1] != cap:
                    return x
                pad = [(0, 0)] * (x.ndim - 1) + [(0, new_cap - cap)]
                return jnp.pad(x, pad)

            state = state.replace(
                r=grow(state.r), dr=grow(state.dr), v=grow(state.v),
                dv=grow(state.dv), a=grow(state.a), E=grow(state.E),
                alive=grow(state.alive), otype=grow(state.otype),
                w=grow(state.w),
                extras={n: grow(x) for n, x in state.extras.items()},
            )
            cap = new_cap

        def put(dst, src):
            src = src.astype(dst.dtype)
            if dst.ndim == 2:
                return lax.dynamic_update_slice(dst, src[:, :k], (0, hwm))
            return lax.dynamic_update_slice(dst, src[:k], (hwm,))

        extras = {}
        for name, arr in state.extras.items():
            if name in sub.extras:
                src = sub.extras[name]
            else:
                shape = (k,) if arr.ndim == 1 else (3, k)
                src = jnp.zeros(shape, arr.dtype)
            extras[name] = put(arr, src)

        for j, o in enumerate(objs):  # identity registry for remove_obj
            self._slot_of[id(o)] = hwm + j

        state = state.replace(
            r=put(state.r, sub.r), dr=put(state.dr, sub.dr),
            v=put(state.v, sub.v), dv=put(state.dv, sub.dv),
            a=put(state.a, sub.a), E=put(state.E, sub.E),
            alive=put(state.alive, sub.alive),
            otype=put(state.otype, sub.otype), w=put(state.w, sub.w),
            extras=extras,
            n_spawned=jnp.asarray(hwm + k, jnp.int32),
        )
        if self.mesh is not None:
            # restore particle-axis placement (the update ops above may have
            # left the outputs replicated or gathered)
            from physicl_tpu.parallel.sharding import shard_state

            state = shard_state(state, self.mesh)
        self._pending_objects.extend(objs)  # id registry (trace, id_info_fn)
        self._hwm = hwm + k
        return state, k

    def _population_policies(self):
        """(shrink_ok, recycle_ok, emit_per_iter) — which slot-moving
        policies apply to the current configuration. Pure function of the
        config, so remove_obj can consult it before the run thread computes
        anything."""
        steps = list(self.steps.values())
        stable_ids = any(getattr(s, "needs_stable_ids", False) for s in steps)
        emit_per_iter = sum(
            getattr(s, "n_per_step", 0) for s in steps
            if getattr(s, "needs_capacity_headroom", False))
        shrink_ok = (
            self.auto_shrink
            and self.mesh is None  # shrink would break shard divisibility
            and self.capacity is None  # user-sized capacity is intentional
            and not stable_ids
            and emit_per_iter == 0
        )
        # Continuous sources allocate slots contiguously and never reuse
        # them; recycle via compaction when the arena nears exhaustion. On
        # meshes — including PROCESS-SPANNING pod meshes — the compaction
        # runs as a sharding-preserving collective (compact_on_mesh): the
        # scatter's cross-shard moves ride ICI/DCN and every process takes
        # the identical recycle decision from the replicated alive count
        # and the deterministic emit schedule, so pod-scale emitters keep
        # emitting past arena exhaustion (VERDICT r3 weak #4).
        recycle_ok = emit_per_iter > 0 and not stable_ids
        return shrink_ok, recycle_ok, emit_per_iter

    @property
    def _slots_stable(self) -> bool:
        shrink_ok, recycle_ok, _ = self._population_policies()
        return not (shrink_ok or recycle_ok
                    or int(self.spatial_sort or 0) > 0)

    @staticmethod
    def _injection_keeps_plan(provider, items) -> bool:
        """True iff injected particles preserve the fused plan's proven
        invariants: the proven species (any species on a mixed plan — the
        otype plane dispatches per particle) and (when the const-norm fast
        path is active) the common particle speed."""
        from physicl_tpu.ops.fused import SPECIES_MIXED

        speed0 = provider.plan.const_norm_speed
        species = provider.plan.species

        def speed_ok(s):
            return speed0 is None or abs(s - speed0) <= 1e-4 * speed0

        for kind, x in items:
            if kind == "obj":
                if (species != SPECIES_MIXED
                        and getattr(x, "_obj_type_code", 0) != species):
                    return False
                if not speed_ok(float(np.linalg.norm(
                        raw_code_value(x.v).reshape(3)))):
                    return False
            else:
                if (species != SPECIES_MIXED
                        and int(x["otype"]) != species):
                    return False
                if speed0 is not None:
                    v = x["v"]
                    if isinstance(v, jax.Array):
                        norms = jnp.sqrt(jnp.sum(
                            v.astype(jnp.float32) ** 2, axis=0))
                        lo = float(jax.device_get(jnp.min(norms)))
                        hi = float(jax.device_get(jnp.max(norms)))
                    else:
                        norms = np.linalg.norm(np.asarray(v, np.float64),
                                               axis=0)
                        lo, hi = float(norms.min()), float(norms.max())
                    if not (speed_ok(lo) and speed_ok(hi)):
                        return False
        return True

    # -- compilation -------------------------------------------------------------

    def _ordered_steps(self) -> List[Step]:
        # Insertion order, NOT index order — reference semantics
        # (physicl/__init__.py:514, examples/trace_ex.py:9-12).
        steps = list(self.steps.values())
        for i, s in enumerate(steps):
            s._step_uid = f"s{i}"
        return steps

    def _probe_exit_traceable(self, state: SimState) -> bool:
        try:
            jax.eval_shape(
                lambda s: jnp.asarray(self.exit(_TracedView(s, self)), jnp.bool_),
                state,
            )
            return True
        except Exception:
            return False

    def _auto_chunk(self, steps: List[Step], state: SimState) -> int:
        """Pick chunk length so per-chunk record buffers stay under budget."""
        def body_shape(s):
            ctx = StepContext(jax.random.PRNGKey(0), self)
            for step in steps:
                s = step.apply(s, ctx)
            return ctx.records

        rec_shapes = jax.eval_shape(body_shape, state)
        bytes_per_iter = sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree_util.tree_leaves(rec_shapes)
        )
        # 1024-iteration cap (fused-path parity): the early-exit while_loop
        # makes overshoot free — a chunk ends the moment the exit predicate
        # fires — so the cap only bounds the record buffer and the latency
        # of chunk-boundary work (population maintenance, at="chunk" steps)
        if bytes_per_iter == 0:
            return 1024
        return int(np.clip(self.max_record_bytes // max(bytes_per_iter, 1),
                           1, 1024))

    def _exit_traced_fn(self, state: SimState):
        """``(fn, tier)``: the device-traceable exit predicate for the
        generic path, or ``(None, "host-exact")``.

        Tiers (cheapest first): a declared intent (``until_t=`` /
        ``exit="extinction"``) or a directly traceable predicate; else, if
        the predicate empirically behaves as 'no objects left' on sampled
        host views (the reference-idiomatic ``lambda x: len(x.objects) ==
        0``, physicl/__init__.py:414 — untraceable because ``len`` cannot
        return a tracer), substitute the equivalent device test
        ``n_alive == 0`` so the run keeps chunked scans instead of dropping
        to one host round trip per iteration; else host-exact (chunk=1).
        """
        if getattr(self.exit, "exit_mode_hint", None) == "n0":
            return (lambda view: view.n_objects == 0), "declared-extinction"
        if self._probe_exit_traceable(state):
            tier = ("declared-t-only"
                    if getattr(self.exit, "exit_mode_hint", None) == "t"
                    else "traced")
            return (lambda view: self.exit(view)), tier
        from physicl_tpu.ops.pipeline import _probe_extinction

        if _probe_extinction(self.exit):
            return (lambda view: view.n_objects == 0), "extinction-probe"
        return None, "host-exact"

    def _build_chunk_fn(self, steps: List[Step], exit_fn, chunk: int,
                        state0: SimState):
        def run_iter(state: SimState):
            key, iter_key = jax.random.split(state.key)
            state = state.replace(key=key)
            ctx = StepContext(iter_key, self)
            for step in steps:
                if getattr(step, "at_boundary", False):
                    continue  # applied between chunks (PopulationManager)
                state = step.apply(state, ctx)
            return state, ctx.records

        # Record template (zeros) for masked-out iterations, fixed at build time.
        rec_shapes = jax.eval_shape(lambda s: run_iter(s)[1], state0)

        # Early-exit while_loop instead of a scan over lax.cond(done, ...):
        # the cond carried the FULL state through a select every iteration
        # (two extra HBM passes over every plane at 10^7 photons) and kept
        # burning whole-chunk dispatch time after extinction. The loop runs
        # exactly the live iterations: exit is checked on the pre-iteration
        # state (same schedule as the reference's `while not exit(self)`,
        # physicl/__init__.py:512), the PRNG stream advances only on live
        # iterations, and records/valid are bit-identical to the scan form.
        def exit_now(state):
            if exit_fn is None:
                return jnp.zeros((), jnp.bool_)
            return jnp.asarray(exit_fn(_TracedView(state, self)), jnp.bool_)

        def cond(carry):
            k, state, done, recs = carry
            return (k < chunk) & jnp.logical_not(done)

        def body(carry):
            k, state, done, recs = carry
            state, row = run_iter(state)
            recs = jax.tree_util.tree_map(
                lambda buf, r: jax.lax.dynamic_update_index_in_dim(
                    buf, r.astype(buf.dtype), k, 0), recs, row)
            return k + 1, state, exit_now(state), recs

        def chunk_fn(state: SimState):
            recs0 = jax.tree_util.tree_map(
                lambda sh: jnp.zeros((chunk,) + sh.shape, sh.dtype),
                rec_shapes)
            k, state, done, records = jax.lax.while_loop(
                cond, body, (jnp.zeros((), jnp.int32), state,
                             exit_now(state), recs0))
            valid = jnp.arange(chunk, dtype=jnp.int32) < k
            return state, done, records, valid

        if self.jit_on:
            from physicl_tpu.utils.cache import (
                enable_persistent_compilation_cache,
            )

            enable_persistent_compilation_cache()  # lazily, pre-compile
            # NOT donated: self.sim_state aliases the input buffers while a
            # chunk executes, and the threaded polling surface (sim.objects,
            # save_checkpoint) may read them concurrently — donation would
            # invalidate them mid-flight. The copy this costs is one
            # state-sized allocation per chunk, amortized over K iterations.
            return jax.jit(chunk_fn)
        return chunk_fn

    # -- run loop ------------------------------------------------------------------

    def run(self) -> None:
        """Thread body wrapper: captures exceptions so ``join()`` re-raises them
        on the caller's thread instead of dying silently."""
        try:
            self._run_impl()
        except BaseException as e:  # noqa: BLE001 — resurfaced in join()
            self.exception = e
            self.running = False
            raise

    def join(self, timeout=None):
        threading.Thread.join(self, timeout)
        exc = getattr(self, "exception", None)
        if exc is not None:
            self.exception = None
            raise exc

    def _init_run_state(self) -> SimState:
        """Build (or restore) the initial device state and host mirrors."""
        restored_hwm = None
        if self._restored is not None:
            from physicl_tpu.utils.checkpoint import repad_state

            state, meta = self._restored
            self._restored = None
            self.ts = list(meta.get("ts", []))
            self._initial_count = int(meta.get("initial_count", 0))
            n0 = int(jax.device_get(state.n_alive))
            # elastic restart: re-pad the particle axis to THIS run's
            # topology (a checkpoint written under an 8-chip mesh resumes
            # on 1 or 4 chips and vice versa). Explicit capacity= wins;
            # otherwise keep the snapshot's capacity, rounded up to the
            # mesh's tile-aligned shard unit.
            hwm = int(meta.get("hwm", state.capacity))
            unit = pad_capacity(1) * (int(self.mesh.devices.size)
                                      if self.mesh is not None else 1)
            want = (self.capacity if self.capacity is not None
                    else state.capacity)
            want = max(want, hwm, 1)
            target = max(unit, ((want + unit - 1) // unit) * unit)
            if target != state.capacity:
                state = repad_state(state, target, hwm=hwm)
            restored_hwm = min(hwm, target)
        else:
            n0 = len(self._pending_objects) + sum(
                int(b["n"]) for b in self._pending_bulk
            )
            self._initial_count = n0
            cap = (self.capacity if self.capacity is not None
                   else pad_capacity(max(n0, 1)))
            if self.mesh is not None:
                # particle axis must split evenly into tile-aligned shards
                unit = pad_capacity(1) * int(self.mesh.devices.size)
                cap = max(unit, ((cap + unit - 1) // unit) * unit)
            state = SimState.from_population(
                self._pending_objects, self._pending_bulk,
                dtype=self.dtype, seed=self.seed, capacity=cap,
                prng_impl=self.prng_impl,
            )
        if self.mesh is not None:
            from physicl_tpu.parallel.sharding import shard_state

            state = shard_state(state, self.mesh)
        self._host_n_alive = n0
        # fresh runs: the initial population occupies slots [0, n0).
        # restored runs: the snapshot's high-water mark (dead-but-used
        # slots included), clamped by any shrink
        self._hwm = n0 if restored_hwm is None else restored_hwm
        self._host_t = float(jax.device_get(state.t))
        self._host_dt = float(jax.device_get(state.dt))
        self.sim_state = state
        return state

    def _build_execution(self, steps: List[Step], state: SimState,
                         allow_fuse: bool = True, warn: bool = True):
        """Choose and compile the execution strategy: the fused Pallas
        pipeline when provable, else the generic scan (chunked when the exit
        predicate traces or behaves as extinction, chunk=1 host-exact
        otherwise). Records the decision in ``self.plan_report`` and warns
        once when the run lands on a drastically slower tier."""
        from physicl_tpu.population import ExecPlan

        provider = None
        refusals: List[tuple] = []
        if allow_fuse and self.fuse == "auto":
            from physicl_tpu.ops.pipeline import try_build_fused

            provider = try_build_fused(self, steps, state, report=refusals)
        if provider is not None:
            from physicl_tpu.ops.fused import SPECIES_MIXED

            # the provider owns exit handling via its `done` output
            species = {OBJ_PHOTON: "photon", OBJ_GENERIC: "generic",
                       SPECIES_MIXED: "mixed (otype-plane dispatch)"}.get(
                           provider.plan.species, str(provider.plan.species))
            notes = [f"population species: {species}"]
            if provider.plan.extras:
                notes.append(
                    "packed per-particle planes: 15 core + "
                    + " + ".join(provider.plan.extras))
            boundary = [type(s).__name__ for s in steps
                        if getattr(s, "at_boundary", False)]
            if boundary:
                notes.append(
                    "chunk-boundary population control between dispatches: "
                    + ", ".join(boundary)
                    + " (applied once per chunk; drains the dispatch "
                    "pipeline each boundary)")
            self.plan_report = PlanReport(
                mode="fused", chunk=provider.plan.chunk,
                fuse_setting=self.fuse, allow_fuse=allow_fuse,
                builder=provider.plan.builder,
                builder_reason=provider.builder_reason,
                exit_tier=("t-schedule (exit iteration precomputed on host)"
                           if provider.exit_mode == "t"
                           else "extinction (in-kernel alive count)"),
                notes=notes)
            return ExecPlan(provider=provider, chunk_fn=provider,
                            exit_traced=True, exit_fn=None,
                            chunk=provider.plan.chunk)

        _, _, emit_per_iter = self._population_policies()
        exit_fn, exit_tier = self._exit_traced_fn(state)
        exit_traced = exit_fn is not None
        # provisional report BEFORE anything traces user step code
        # (_auto_chunk / _build_chunk_fn): a step that raises at trace time
        # (e.g. polarization's missing-planes error) still leaves the fused
        # refusal trail readable through sim.explain_plan()
        self.plan_report = PlanReport(
            mode="generic", chunk=-1, fuse_setting=self.fuse,
            allow_fuse=allow_fuse, exit_tier=exit_tier, refusals=refusals,
            notes=["provisional: step compilation did not finish"])
        if not exit_traced:
            # host-exact mode: the predicate must be checked every iteration;
            # a larger chunk_steps would overshoot the exit
            chunk = 1
        elif self.chunk_steps is not None:
            chunk = int(self.chunk_steps)
        else:
            chunk = self._auto_chunk(steps, state)
        if emit_per_iter:
            # one chunk's emissions must fit in half the arena (slots
            # recycle only at chunk boundaries)
            chunk = max(1, min(chunk,
                               (state.capacity // 2) // emit_per_iter))
        self.chunk_used = chunk  # observability: 1 == host-exact mode
        gen_notes = []
        boundary = [type(s).__name__ for s in steps
                    if getattr(s, "at_boundary", False)]
        if boundary:
            gen_notes.append(
                "chunk-boundary population control between chunks: "
                + ", ".join(boundary))
        gen_notes.append(
            "generic tier: each iteration is a jitted scan step whose "
            "state crosses device memory every iteration; make every "
            "step fusable for the fused tier (the refusals above name "
            "what blocked it)")
        self.plan_report = PlanReport(
            mode="host-exact" if chunk == 1 and not exit_traced
            else "generic", chunk=chunk, fuse_setting=self.fuse,
            allow_fuse=allow_fuse, exit_tier=exit_tier, refusals=refusals,
            notes=gen_notes)
        if warn and not self._warned_fallback:
            msg = None
            if not exit_traced:
                msg = (f"host-exact mode (chunk=1): exit predicate "
                       f"{getattr(self.exit, '__name__', repr(self.exit))} "
                       "is neither traceable nor extinction-shaped, so it is "
                       "checked on the host every iteration (orders of "
                       "magnitude slower). Declare intent with Simulation("
                       "until_t=...) or exit='extinction', or restrict it to "
                       "sim.t/sim.dt or `len(sim.objects) == 0`. "
                       "sim.explain_plan() has the full decision.")
            elif refusals:
                code, detail = refusals[0]
                msg = (f"fused pipeline refused [{code}]: {detail} — "
                       "running the generic scan instead. "
                       "sim.explain_plan() has the full decision.")
            elif not allow_fuse and self.fuse == "auto":
                msg = ("fused pipeline disabled for the rest of the run: "
                       "a mid-run injection broke its proven invariants "
                       "(off-species or off-speed particles); continuing on "
                       "the generic scan. sim.explain_plan() has details.")
            if msg is not None:
                self._warned_fallback = True
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        chunk_fn = self._build_chunk_fn(steps, exit_fn, chunk, state)
        return ExecPlan(provider=None, chunk_fn=chunk_fn,
                        exit_traced=exit_traced, exit_fn=exit_fn, chunk=chunk)

    def explain_plan(self) -> str:
        """Human-readable account of the chosen execution strategy: fused /
        generic / host-exact, the chunk size, the exit-handling tier, and —
        when the fused Pallas pipeline was refused — every structured reason
        from the prover. Callable before ``start()`` (plans without
        compiling or warning) or any time after."""
        if self.plan_report is None:
            # Dry pass: must not consume a pending checkpoint restore, and
            # must not PIN the device arena it transiently materializes —
            # the real run allocates its own in run(), and holding both
            # doubles peak HBM (code-review finding). The transient state
            # is dropped before returning; planning never compiles (fused
            # kernels build lazily at first dispatch).
            restored, prior_state = self._restored, self.sim_state
            try:
                steps = self._ordered_steps()
                state = self._init_run_state()
                self._build_execution(steps, state, warn=False)
            finally:
                self._restored = restored
                self.sim_state = prior_state
        return self.plan_report.describe()

    def _collect_records(self, steps, records, dev_keys, n_valid) -> None:
        """Fetch host record channels (device channels pass through as jax
        arrays), trim to the valid prefix, and hand each step its slice."""
        # Pod meshes: per-photon channels (E-list capture) are sharded across
        # processes — replicate them to every host first (one collective per
        # channel per chunk; every process harvests in lockstep). Everything
        # else ships in one batched device_get (one host sync instead of
        # one per channel).
        spanning = {
            k: v for k, v in records.items()
            if k not in dev_keys and isinstance(v, jax.Array)
            and not v.is_fully_addressable
        }
        if dev_keys or spanning:
            records_np = jax.device_get(
                {k: v for k, v in records.items()
                 if k not in dev_keys and k not in spanning})
            from physicl_tpu.parallel.distributed import fetch_to_every_host
            records_np.update(
                {k: fetch_to_every_host(v) for k, v in spanning.items()})
            records_np.update(
                {k: v for k, v in records.items() if k in dev_keys})
        else:
            records_np = jax.device_get(records)

        def trim(v, is_dev):
            if not is_dev:
                return np.asarray(v)[:n_valid]
            # device channel: a full-length slice would dispatch a device
            # copy for nothing — only trim when the chunk actually ended early
            if getattr(v, "shape", (None,))[0] == n_valid:
                return v
            return v[:n_valid]

        for s in steps:
            prefix = f"{s._step_uid}/"
            local = {
                k[len(prefix):]: trim(v, k in dev_keys)
                for k, v in records_np.items()
                if k.startswith(prefix)
            }
            if local:
                s.collect(self, local)

    def _harvest_fused(self, provider, inflight, steps, dev_keys):
        """Fetch one dispatched chunk's records, publish host stats, and hand
        each step its slice. Returns ``(done, final_state)``."""
        done, final_state, records, n_valid, stats = provider.harvest(inflight)
        with self._state_lock:
            if done:
                # the definitive end state (an extinction trim may have
                # repaired t/dt; a speculative later chunk may have been
                # dispatched — its state is garbage and is discarded here)
                self.sim_state = final_state
            self._host_t = stats["t"]
            self._host_dt = stats["dt"]
            self._host_n_alive = stats["n_alive"]
            self.t = Measurement.from_code(self._host_t, "s**1")
            self.dt = Measurement.from_code(self._host_dt, "s**1")
        self._collect_records(steps, records, dev_keys, n_valid)
        return done, final_state

    def _setup_spatial_sort(self, steps):
        """Resolve the ``spatial_sort=K`` knob into a jitted reorder (or
        None), warning with a structured reason when it cannot apply —
        mirroring the fused-plan refusal style."""
        every = int(self.spatial_sort or 0)
        if every <= 0:
            return None
        if any(getattr(s, "needs_stable_ids", False) for s in steps):
            warnings.warn(
                "spatial_sort disabled [stable-ids]: a step needs stable "
                "particle slots (path tracing records rows by slot id)",
                RuntimeWarning)
            return None
        spec = None
        for s in steps:
            for attr in ("variable_n_fn", "_n_fn", "n_fn"):
                f = getattr(s, attr, None)
                if f is not None and getattr(f, "vox_spec",
                                             None) is not None:
                    spec = f.vox_spec
                    break
            if spec is not None:
                break
        if spec is None:
            warnings.warn(
                "spatial_sort disabled [no-voxel-table]: no voxel_density "
                "medium with an in-kernel table to key the sort on",
                RuntimeWarning)
            return None
        from physicl_tpu.ops.compaction import make_spatial_sort

        return make_spatial_sort(spec, self.mesh)

    def _maybe_spatial_sort(self, state: SimState) -> SimState:
        """Every ``spatial_sort``-th chunk dispatch, reorder the population
        by flat voxel index (pure device op: no pipeline drain, no host
        traffic — see ops/compaction.make_spatial_sort)."""
        if self._sort_fn is not None:
            if self._sort_tick % self._sort_every == 0:
                state = self._sort_fn(state)
            self._sort_tick += 1
        return state

    def _drive_fused(self, plan, pop, steps, state: SimState, dev_keys):
        """Pipelined fused dispatch loop: enqueue chunk k+1 before fetching
        chunk k's records, so the host's per-chunk work (record fetch,
        schedule replay) overlaps kernel execution instead of serializing
        with it. Population maintenance (inject/remove/recycle/shrink) needs a
        definitive host view, so the pipeline drains before it runs.

        Returns ``(state, finished)``; ``finished=False`` means a mid-run
        injection broke the fused plan and the caller should continue on the
        (rebuilt, generic) plan.
        """
        from collections import deque

        provider = plan.provider
        # outstanding chunks beyond the one being harvested: at depth >= 2
        # the harvested chunk has usually already retired, so the fetch costs
        # only the transfer and the loop sustains back-to-back kernels.
        # Extinction runs may speculatively execute up to `depth` chunks past
        # the exit — harmless (ops mask by alive; n0-mode excludes emitters)
        # — and get_state() host stats lag by the same amount.
        depth = max(1, int(getattr(self, "fused_pipeline_depth", 4)))
        if provider.plan.n_stream:
            # each in-flight stream-plane chunk holds up to max_record_bytes
            # of HBM (trace buffers): cap the pipeline so worst-case
            # held-buffer footprint stays at ~2 budgets
            depth = min(depth, 2)
        pending: deque = deque()

        def drain_one():
            return self._harvest_fused(provider, pending.popleft(), steps,
                                       dev_keys)

        while True:
            pop.check_divergence()  # multi-host: queued edits must match
            if pop.needs_attention(state, plan):
                while pending:  # maintenance needs a definitive host view
                    done, final_state = drain_one()
                    if done:
                        return final_state, True
                state = pop.maintain(state, plan)
                if plan.provider is not provider:
                    return state, False  # fused plan broken: go generic
                # fall through to dispatch: maintenance may be a no-op (e.g.
                # shrink already at minimum capacity), so progress must not
                # depend on needs_attention() turning false
            state = self._maybe_spatial_sort(state)
            inflight = provider.dispatch(state)
            state = inflight.state
            with self._state_lock:
                self.sim_state = state
            pending.append(inflight)
            if inflight.done_t:  # t-mode exit inside this chunk: no more work
                while pending:
                    done, final_state = drain_one()
                    if done:
                        return final_state, True
            while len(pending) > depth:
                done, final_state = drain_one()
                if done:
                    # the chunks still pending were speculative overshoot;
                    # their records are never collected and the definitive
                    # state replaces theirs
                    return final_state, True

    def _run_impl(self) -> None:
        """Drive chunked scans until the exit predicate fires, then run every
        step's ``terminate``. Slot-moving policies (recycle/shrink/remove/
        inject) live in :class:`physicl_tpu.population.PopulationManager`."""
        from physicl_tpu.population import PopulationManager

        self.start_time = time.time()
        self.ts = []
        self.running = True
        self._objects_cache = None
        # identity registry for mid-run remove_obj (objects map to the first
        # slots in insertion order); built before any slow device work
        self._slot_of = {id(o): i for i, o in enumerate(self._pending_objects)}

        state = self._init_run_state()
        steps = self._ordered_steps()
        for s in steps:
            s.setup(self)
        # record channels that must stay device-resident (path tracing):
        # the engine never device_gets them; the owning step holds the jax
        # arrays and the host sees them only on explicit assembly
        dev_keys = {f"{s._step_uid}/{nm}" for s in steps
                    for nm in getattr(s, "device_records", ())}

        plan = self._build_execution(steps, state)
        self.used_fused = plan.provider is not None
        self._sort_fn = self._setup_spatial_sort(steps)
        self._sort_every = max(1, int(self.spatial_sort or 0))
        self._sort_tick = 0
        if self._sort_fn is not None and self.plan_report is not None:
            self.plan_report.notes.append(
                f"spatial sort: population reordered by flat voxel index "
                f"every {self._sort_every} chunk dispatch(es) — restores "
                f"per-tile table-walk locality for mixed populations "
                f"(slot order is not insertion order)")
        pop = PopulationManager(self, steps)
        # chunk-boundary importance snapshots start from the INITIAL
        # positions on both paths (the fused loop's pre-dispatch maintain
        # would prime them anyway; the generic loop maintains only after
        # the first chunk and would otherwise lose its climb)
        pop.prime_boundary_snapshots(state)

        skip_maintain_once = False
        while True:
            if plan.provider is not None:
                state, finished = self._drive_fused(plan, pop, steps, state,
                                                    dev_keys)
                if finished:
                    break
                # the fallback happened INSIDE a maintain() call — don't
                # run a second one (boundary splits would apply twice at
                # the same boundary) before the first generic chunk
                skip_maintain_once = True
                continue  # plan fell back to the generic scan mid-run
            if not plan.exit_traced:
                # host-exact predicate checked BEFORE maintenance, so
                # chunk-boundary population control never runs after the
                # final iteration (it would alter the user-visible final
                # state; the fused path gets the same guarantee via
                # provider.exit_pending)
                view = _HostView(self, self._host_t, self._host_dt,
                                 self._host_n_alive)
                if bool(self.exit(view)):
                    break
            if skip_maintain_once:
                skip_maintain_once = False
            else:
                pop.check_divergence()  # multi-host: queued edits must match
                state = pop.maintain(state, plan)
            if plan.exit_traced:
                # host-exact (chunk=1) mode keeps insertion order — its
                # object views are user-visible every iteration
                state = self._maybe_spatial_sort(state)
            state, done, records, valid = plan.chunk_fn(state)
            # one batched transfer: one host sync instead of five
            valid_np, done_np, t_np, dt_np, n_np = jax.device_get(
                (valid, done, state.t, state.dt, state.n_alive))
            n_valid = int(np.asarray(valid_np).sum())
            with self._state_lock:
                self.sim_state = state
                self._host_t = float(t_np)
                self._host_dt = float(dt_np)
                self._host_n_alive = int(n_np)
                self.t = Measurement.from_code(self._host_t, "s**1")
                self.dt = Measurement.from_code(self._host_dt, "s**1")
            self._collect_records(steps, records, dev_keys, n_valid)
            if plan.exit_traced and bool(done_np):
                break
            if not plan.exit_traced and n_valid == 0:
                break

        state = pop.flush_removals(state)
        with self._state_lock:
            for s in steps:
                s.terminate(self)
            self.run_time = time.time() - self.start_time
            self.running = False
