"""Structure-of-arrays simulation state (the replacement for ``sim.objects``).

The reference keeps an array-of-structs Python list of ``Object`` instances and
loops over it in the interpreter every step (``physicl/__init__.py:421,447,514``).
Here the whole particle population is a pytree of device-resident arrays, padded
to a fixed capacity, with an ``alive`` mask instead of list mutation
(``remove_obj``, ``physicl/light.py:203-205``). Component-major ``(3, C)`` layout
keeps the particle axis last and contiguous (it tiles to rows of 128).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SimState", "OBJ_GENERIC", "OBJ_PHOTON", "pad_capacity"]

# Object type codes stored in SimState.otype (replaces per-object isinstance
# checks like ``PhotonObject != type(obj): continue`` in physicl/light.py:176).
OBJ_GENERIC = 0
OBJ_PHOTON = 1

_LANE = 128
_SUBLANE = 8


def mod_floor(x, L):
    """``x mod L`` (L > 0) via explicit floor-divide-multiply-subtract.

    ``jnp.mod``/``lax.rem`` lower through backend- and CONTEXT-dependent
    expansions (on CPU the rem inside a while_loop body rounds differently
    from the same rem inside a scan body — observed 1-ulp divergence at a
    periodic wrap seam), which breaks the framework's fused==generic
    bitwise-parity contract. Spelling the mod out in correctly-rounded
    primitives (floor, div, mul, sub — XLA forms no FMAs from separate HLO
    ops) makes every execution path compute the identical value. The two
    guards absorb the 1-ulp cases where the floored quotient lands the
    remainder at exactly L or just below 0."""
    y = x - jnp.floor(x / L) * L
    y = jnp.where(y < 0, y + L, y)
    return jnp.where(y >= L, y - L, y)


def pad_capacity(n: int) -> int:
    """Round particle count up to a tile-aligned capacity.

    Multiple of 128*128 = 16384, so the packed (rows, 128) state always
    divides into whole kernel blocks of any power-of-two row count up to
    128. Padding is dead slots: ~1.6% at 1e6 photons, irrelevant at 1e7.
    """
    tile = _LANE * _LANE
    return max(tile, ((n + tile - 1) // tile) * tile)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    """Device-resident particle state.

    Vector fields are ``(3, C)`` (component-major); scalars per particle are
    ``(C,)``. ``alive`` masks padding and deleted particles. All values are in
    *code units* (the ``Measurement`` scale is applied before upload, so unit
    bookkeeping compiles away).
    """

    r: jax.Array            # (3, C) position
    dr: jax.Array           # (3, C) change in position last step
    v: jax.Array            # (3, C) velocity
    dv: jax.Array           # (3, C) change in velocity last step
    a: jax.Array            # (3, C) acceleration
    E: jax.Array            # (C,)  energy (photons)
    alive: jax.Array        # (C,)  bool
    otype: jax.Array        # (C,)  int32 object type code
    w: jax.Array            # (C,)  statistical weight (Monte Carlo variance
                            #       reduction: implicit capture / roulette
                            #       rescale it; 1.0 for analog transport)
    t: jax.Array            # ()    simulation time
    dt: jax.Array           # ()    last time increment
    key: jax.Array          # PRNG key
    n_spawned: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    # ^ device-side high-water slot mark: in-scan emitters allocate slots
    #   [n_spawned, n_spawned+k); host injection keeps it in sync
    t_comp: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros(()))
    # ^ Kahan compensation for the clock: device scalars are f32 (no x64), so
    #   the generic path's on-device ``t += dt`` would drift by O(n*eps) over
    #   long runs; compensated summation keeps ``t`` within ~1 ulp of the
    #   exact sum. The fused path replays the SAME f32 Kahan arithmetic on
    #   the host (ops/pipeline.py:_host_schedule), so ``sim.ts`` is
    #   byte-identical between paths and (t, t_comp) round-trips losslessly.
    #   Matches the reference's f64 sim.t, physicl/__init__.py:341-343.
    extras: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.r.shape[-1]

    @property
    def n_alive(self) -> jax.Array:
        return jnp.sum(self.alive.astype(jnp.int32))

    @staticmethod
    def zeros(capacity: int, dtype=jnp.float32, seed: int = 0) -> "SimState":
        f = lambda *shape: jnp.zeros(shape, dtype)
        return SimState(
            r=f(3, capacity), dr=f(3, capacity), v=f(3, capacity),
            dv=f(3, capacity), a=f(3, capacity), E=f(capacity),
            alive=jnp.zeros((capacity,), jnp.bool_),
            otype=jnp.zeros((capacity,), jnp.int32),
            w=jnp.ones((capacity,), dtype),
            t=jnp.zeros((), dtype), dt=jnp.zeros((), dtype),
            key=jax.random.PRNGKey(seed),
        )

    @staticmethod
    def make_key(seed: int, prng_impl: str | None = None):
        """PRNG key for the generic path. ``prng_impl='rbg'`` uses the
        RBG generator (cheaper bits; stream not reproducible across
        backends); default is JAX's threefry."""
        if prng_impl:
            return jax.random.key(seed, impl=prng_impl)
        return jax.random.PRNGKey(seed)

    @staticmethod
    def from_population(objects, bulks=(), dtype=jnp.float32, seed: int = 0,
                        capacity: int | None = None,
                        prng_impl: str | None = None) -> "SimState":
        """Build SoA state from host ``Object`` instances plus bulk populations.

        This replaces the reference's per-step gather/upload loops
        (``physicl/__init__.py:602-629``): conversion happens a single time at
        ``Simulation.start()`` and state stays in HBM for the whole run.

        ``bulks`` is a sequence of dicts from
        :func:`physicl_tpu.light.generate_photon_state` — the fast path that
        skips per-particle Python objects entirely.
        """
        from physicl_tpu.units import raw_code_value

        n_obj = len(objects)
        n_bulk = sum(int(b["n"]) for b in bulks)
        n = n_obj + n_bulk
        cap = capacity if capacity is not None else pad_capacity(max(n, 1))
        if cap < n:
            raise ValueError(f"capacity {cap} < object count {n}")

        # Device-native fast path: a single bulk population whose arrays are
        # already on device (generate_photon_state(..., device=True)) builds
        # the state with jnp ops — no host staging, no upload.
        if not objects and len(bulks) == 1 and isinstance(
                bulks[0]["E"], jax.Array):
            b = bulks[0]
            k = int(b["n"])

            def pad_vec(x):
                x = jnp.asarray(x, dtype)
                return jnp.pad(x, ((0, 0), (0, cap - k)))

            zeros3 = jnp.zeros((3, cap), dtype)
            idx = jnp.arange(cap)
            if "w" in b:
                w = jnp.pad(jnp.asarray(b["w"], dtype), (0, cap - k),
                            constant_values=1.0)
            else:
                w = jnp.ones((cap,), dtype)
            dev_extras = {}
            for name, arr in b.get("extras", {}).items():
                arr = jnp.asarray(arr, dtype)
                dev_extras[name] = (
                    jnp.pad(arr, (0, cap - k)) if arr.ndim == 1
                    else jnp.pad(arr, ((0, 0), (0, cap - k))))
            return SimState(
                r=pad_vec(b["r"]), dr=zeros3, v=pad_vec(b["v"]),
                dv=zeros3, a=zeros3,
                E=jnp.pad(jnp.asarray(b["E"], dtype), (0, cap - k)),
                alive=idx < k,
                otype=jnp.where(idx < k, jnp.int32(b["otype"]),
                                jnp.int32(0)),
                w=w,
                t=jnp.zeros((), dtype), dt=jnp.zeros((), dtype),
                key=SimState.make_key(seed, prng_impl),
                n_spawned=jnp.asarray(k, jnp.int32),
                extras=dev_extras,
            )

        np_dtype = np.dtype(jnp.zeros((), dtype).dtype)

        vec = {name: np.zeros((3, cap), np_dtype) for name in
               ("r", "dr", "v", "dv", "a")}
        E = np.zeros((cap,), np_dtype)
        otype = np.zeros((cap,), np.int32)
        w = np.ones((cap,), np_dtype)

        # Arbitrary extra numeric attributes (reference Objects accept any
        # kwargs, physicl/__init__.py:395-396): scalars -> (C,), 3-vectors
        # -> (3, C), exposed as state.extras[name]. ``w`` is the statistical
        # weight and routes to its first-class plane instead.
        core = {"r", "dr", "v", "dv", "a", "E", "w"}
        extras_spec: Dict[str, int] = {}
        for o in objects:
            for name, val in vars(o).items():
                if name.startswith("_") or name in core:
                    continue
                arr = np.asarray(raw_code_value(val), dtype=np.float64)
                if arr.shape == ():
                    extras_spec.setdefault(name, 0)
                elif arr.shape == (3,):
                    extras_spec.setdefault(name, 3)
        # Bulk populations may carry per-particle extras too: (k,) scalars
        # or (3, k) vectors under the "extras" key (e.g. Stokes planes from
        # physicl_tpu.polarization.polarized_photon_state).
        for b in bulks:
            for name, arr in b.get("extras", {}).items():
                extras_spec.setdefault(
                    name, 0 if np.asarray(arr).ndim == 1 else 3)
        extras = {
            name: np.zeros((cap,) if dim == 0 else (3, cap), np_dtype)
            for name, dim in extras_spec.items()
        }

        for i, o in enumerate(objects):
            for name in vec:
                vec[name][:, i] = raw_code_value(getattr(o, name)).reshape(3)
            E[i] = float(raw_code_value(getattr(o, "E", 0.0)))
            w[i] = float(raw_code_value(getattr(o, "w", 1.0)))
            otype[i] = getattr(o, "_obj_type_code", OBJ_GENERIC)
            for name, dim in extras_spec.items():
                if hasattr(o, name):
                    val = raw_code_value(getattr(o, name))
                    if dim == 0:
                        extras[name][i] = float(val)
                    else:
                        extras[name][:, i] = np.asarray(val).reshape(3)
        off = n_obj
        for b in bulks:
            k = int(b["n"])
            sl = slice(off, off + k)
            vec["r"][:, sl] = b["r"]
            vec["v"][:, sl] = b["v"]
            E[sl] = b["E"]
            if "w" in b:
                w[sl] = b["w"]
            otype[sl] = int(b["otype"])
            for name, arr in b.get("extras", {}).items():
                arr = np.asarray(arr, np.float64)
                if arr.ndim == 1:
                    extras[name][sl] = arr
                else:
                    extras[name][:, sl] = arr
            off += k
        alive = np.zeros((cap,), bool)
        alive[:n] = True

        return SimState(
            r=jnp.asarray(vec["r"]), dr=jnp.asarray(vec["dr"]),
            v=jnp.asarray(vec["v"]), dv=jnp.asarray(vec["dv"]),
            a=jnp.asarray(vec["a"]), E=jnp.asarray(E),
            alive=jnp.asarray(alive), otype=jnp.asarray(otype),
            w=jnp.asarray(w),
            t=jnp.zeros((), dtype), dt=jnp.zeros((), dtype),
            key=SimState.make_key(seed, prng_impl),
            n_spawned=jnp.asarray(n, jnp.int32),
            extras={k: jnp.asarray(v) for k, v in extras.items()},
        )

    @staticmethod
    def from_objects(objects, dtype=jnp.float32, seed: int = 0,
                     capacity: int | None = None) -> "SimState":
        return SimState.from_population(objects, (), dtype, seed, capacity)
