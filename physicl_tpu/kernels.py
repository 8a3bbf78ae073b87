"""Declarative kernel bridge: the counterpart of the reference's
``CLInput``/``CLOutput``/``CLProgram`` metaprogrammed host<->device marshal
(physicl/__init__.py:543-664).

The reference assembles an OpenCL C kernel from input/output metadata and
``exec``-generates per-object gather loops. Here the same declarative surface
(gather an attribute per particle, per-particle random draws, scalar
constants, type filters, tracked hands-back) compiles to vectorized XLA:

* gathers are SoA slices (no per-object loop — the attribute arrays already
  live on device);
* ``obj_def`` draws like ``np.random.random()`` become batched
  ``jax.random`` calls;
* the kernel body is a Python function over jnp arrays (one virtual lane per
  particle), jit-compiled — strictly more expressive than C-string splicing
  and still a single fused device launch;
* ``obj_track`` returns particle indices instead of Python object refs.

Intended uses: standalone experimentation (the reference's
``__CLProgram_scratch.ipynb`` pattern) and embedding custom physics into the
simulation loop via :class:`KernelStep`.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.engine import Simulation, Step, StepContext
from physicl_tpu.state import OBJ_PHOTON, SimState

__all__ = ["KernelInput", "KernelOutput", "KernelProgram", "KernelStep"]

_ATTR_RE = re.compile(r"^(?P<name>[A-Za-z_]\w*)(?:\[(?P<idx>\d)\])?$")

_VEC_FIELDS = {"r", "dr", "v", "dv", "a"}
_SCALAR_FIELDS = {"E"}


def _gather(state: SimState, attr: str) -> jax.Array:
    """Resolve an ``obj_attr`` spec like ``dr[0]``, ``E`` against SoA state."""
    m = _ATTR_RE.match(attr.strip())
    if not m:
        raise ValueError(f"Unsupported obj_attr spec {attr!r}")
    name, idx = m.group("name"), m.group("idx")
    if name in _VEC_FIELDS:
        field = getattr(state, name)
        if idx is None:
            return field  # (3, C)
        return field[int(idx)]
    if name in _SCALAR_FIELDS:
        if idx is not None:
            raise ValueError(f"{name} is scalar per particle")
        return getattr(state, name)
    if name in state.extras:
        return state.extras[name]
    raise ValueError(f"Unknown particle attribute {name!r}")


class KernelInput:
    """Kernel-argument metadata (parity constructor with CLInput,
    physicl/__init__.py:543-560).

    types:
      * ``obj``        — gather ``obj_attr`` per particle (e.g. ``"dr[0]"``);
      * ``obj_def``    — per-particle value; ``obj_def`` may be the literal
        string ``"np.random.random()"`` (optionally ``* <expr>``) for a
        batched uniform draw, or a callable ``f(key, n) -> (n,) array``;
      * ``const``      — scalar kernel argument (``const_value``);
      * ``obj_action`` — particle filter; ``code`` may be a callable
        ``f(state) -> bool mask`` or the literal reference photon-type check
        (anything mentioning ``PhotonObject``) which filters to photons;
      * ``obj_track``  — hands back the selected particles' indices after
        ``run()`` (SoA replacement for tracking Python object refs).
    """

    types = ["obj", "obj_def", "obj_action", "obj_track", "const"]

    def __init__(self, **kwargs):
        self.name = kwargs["name"]
        self.type = kwargs["type"]
        self.obj_attr = kwargs.get("obj_attr")
        self.obj_def = kwargs.get("obj_def")
        self.code = kwargs.get("code")
        self.const_value = kwargs.get("const_value")
        self.ctype = kwargs.get("ctype", "double")

    def _sampler(self):
        d = self.obj_def
        if callable(d):
            return d
        text = str(d).strip()
        m = re.match(r"^np\.random\.random\(\)\s*(?:\*\s*(?P<mul>.+))?$", text)
        if m:
            mul = float(eval(m.group("mul"), {"np": np}, {})) if m.group("mul") else 1.0
            return lambda key, n: jax.random.uniform(key, (n,)) * mul
        raise ValueError(
            f"obj_def {d!r} not recognized. The reference's CLProgram "
            "accepted arbitrary host expressions here "
            "(physicl/__init__.py:544-556); migrating users should pass a "
            "callable ``f(key, n) -> (n,) array`` instead — strictly more "
            "general, and it runs batched on device. The literal string "
            "'np.random.random()' (optionally '* <scale>') is still "
            "accepted for the common uniform-draw case.")


class KernelOutput:
    """Kernel output metadata (parity with CLOutput, physicl/__init__.py:562-565)."""

    _CTYPES = {"double": jnp.float32, "float": jnp.float32, "int": jnp.int32}

    def __init__(self, **kwargs):
        self.name = kwargs["name"]
        self.ctype = kwargs.get("ctype", "double")

    @property
    def dtype(self):
        return self._CTYPES.get(self.ctype, jnp.float32)


class KernelProgram:
    """Declarative particle kernel (parity surface with CLProgram,
    physicl/__init__.py:567-664).

    ``kernel_fn(**inputs) -> dict`` is the kernel body: it receives one jnp
    array per declared input (particle-axis vectors for obj/obj_def, scalars
    for const) plus ``valid`` (the filter mask) and must return
    ``{output_name: array}``. ``build_kernel()`` jit-compiles the whole
    gather->body pipeline into one XLA launch; ``run()`` executes it against
    the simulation's current device state and returns numpy outputs.
    """

    def __init__(self, sim: Optional[Simulation], name: str,
                 kernel_fn: Callable[..., Dict[str, jax.Array]]):
        self.sim = sim
        self.prog_name = name
        self.kernel_fn = kernel_fn
        self.prep_metadata: List[KernelInput] = []
        self.output_metadata: List[KernelOutput] = []
        self._compiled = None
        self._seed_counter = 0

    def build_kernel(self):
        ins = self.prep_metadata
        outs = self.output_metadata

        def pipeline(state: SimState, key):
            mask = state.alive
            for item in ins:
                if item.type == "obj_action":
                    if callable(item.code):
                        mask = mask & item.code(state)
                    elif "PhotonObject" in str(item.code):
                        mask = mask & (state.otype == OBJ_PHOTON)
                    else:
                        raise ValueError(
                            f"obj_action {item.code!r}: pass a callable mask fn")
            kwargs: Dict[str, jax.Array] = {"valid": mask}
            for item in ins:
                if item.type == "obj":
                    kwargs[item.name] = _gather(state, item.obj_attr)
                elif item.type == "obj_def":
                    key, sub = jax.random.split(key)
                    kwargs[item.name] = item._sampler()(sub, state.capacity)
                elif item.type == "const":
                    kwargs[item.name] = jnp.asarray(float(item.const_value))
            result = self.kernel_fn(**kwargs)
            return ({o.name: jnp.asarray(result[o.name], o.dtype)
                     for o in outs}, mask)

        self._compiled = jax.jit(pipeline)
        return self

    def run(self, state: Optional[SimState] = None) -> Dict[str, np.ndarray]:
        if self._compiled is None:
            self.build_kernel()
        if state is None:
            state = self.sim.sim_state
            if state is None:
                state = SimState.from_population(
                    self.sim._pending_objects, self.sim._pending_bulk)
        self._seed_counter += 1
        key = jax.random.fold_in(jax.random.PRNGKey(
            getattr(self.sim, "seed", 0) if self.sim else 0),
            self._seed_counter)
        out, mask = self._compiled(state, key)
        host = {k: np.asarray(jax.device_get(v)) for k, v in out.items()}
        for item in self.prep_metadata:
            if item.type == "obj_track":
                # indices of the particles the kernel actually selected
                # (alive AND passing every obj_action filter)
                setattr(self, item.name,
                        np.nonzero(np.asarray(jax.device_get(mask)))[0])
        return host


class KernelStep(Step):
    """Embed a custom traced kernel in the simulation loop.

    ``fn(state, ctx) -> state`` with full access to the SoA state and the
    per-iteration PRNG stream — the idiomatic replacement for authoring a
    reference Step whose ``run`` drives a CLProgram
    (e.g. physicl/light.py:225-260). Optional ``record_fn(state) -> dict``
    adds measurement channels collected per chunk.

    ``elementwise=True`` is the user's contract that ``fn`` is a pure
    per-particle map, which lets the fusability prover trace it INTO the
    fused Pallas kernel (the migrated-CLProgram fast path) instead of
    forcing the whole pipeline onto the generic scan. The contract:

    * no reductions, gathers, or cross-particle mixing (inside the kernel
      ``fn`` sees one tile, so a reduction would silently be
      tile-local);
    * touch only the packed transport fields — ``r, dr, v, dv, E, w`` and
      ``alive`` (which can only clear); use
      :class:`physicl_tpu.engine.ElementwiseStep` with ``extras=`` for aux
      planes;
    * no ``ctx`` PRNG or records (``ctx.next_key``/``ctx.record`` raise a
      structured refusal at plan time — randomness needs
      ``ElementwiseStep``'s ``p.uniform()``, measurement needs
      ``ReduceMeasureStep``), and no ``record_fn``.

    The contract is VERIFIED at plan time (ops/pipeline._probe_kernelstep;
    violations refuse to the generic scan with a structured reason rather
    than silently computing divergent physics in-kernel):

    * reads of ``state.key``/``state.a``/``state.extras`` trip poisoned
      stand-ins (the in-kernel facade has no PRNG key, reads zeros for
      ``a``, and carries no extras);
    * writes to ``a``/``extras``/``t``/``dt``/``n_spawned`` — ignored
      in-kernel, applied on the generic path — are detected on the
      returned state;
    * the elementwise claim itself is checked behaviorally on a tiny CPU
      state: a row-permuted input must produce the identically-permuted
      output, perturbing one particle must not change any other particle's
      outputs, and tiling the population must not change per-row results
      (catching gathers, reductions, index- and capacity-dependence).
    """

    def __init__(self, fn: Callable[[SimState, StepContext], SimState],
                 record_fn: Optional[Callable[[SimState], Dict]] = None,
                 elementwise: bool = False):
        self.fn = fn
        self.record_fn = record_fn
        self.elementwise = bool(elementwise)
        self.data: List = []

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        prev_alive = state.alive
        state = self.fn(state, ctx)
        if self.elementwise:
            # the elementwise contract: alive only clears (both paths —
            # the fused kernel ANDs identically; a resurrect would corrupt
            # emit/recycle slot accounting)
            state = state.replace(alive=prev_alive & state.alive)
        if self.record_fn is not None:
            for k, v in self.record_fn(state).items():
                ctx.record(self, k, v)
        return state

    def collect(self, sim, records):
        n = len(next(iter(records.values()))) if records else 0
        for i in range(n):
            self.data.append({k: v[i] for k, v in records.items()})
