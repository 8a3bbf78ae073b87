"""Checkpoint / resume.

The reference has no checkpointing (SURVEY.md §5: persistence is only the
CSV dump at terminate). Here the whole simulation state is a small pytree of
arrays, so snapshot/restore is a single fetch: ``save_checkpoint`` writes an
.npz with every SoA field plus clock/PRNG state and the ``sim.ts`` log;
``Simulation.restore_checkpoint`` resumes a run from it.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.state import SimState

__all__ = ["save_checkpoint", "load_checkpoint", "state_from_checkpoint",
           "repad_state"]

_FIELDS = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t", "dt",
           "key", "n_spawned", "t_comp")


def save_checkpoint(sim, path: str) -> None:
    """Snapshot a Simulation (running or finished) to ``path`` (.npz)."""
    state = sim.sim_state
    if state is None:
        state = SimState.from_population(sim._pending_objects,
                                         sim._pending_bulk, seed=sim.seed)
    with sim._state_lock:
        host, key_impl = {}, None
        for f in _FIELDS:
            v = getattr(state, f)
            if f == "key" and v is not None and jax.dtypes.issubdtype(
                    v.dtype, jax.dtypes.prng_key):
                # typed key arrays (prng_impl="rbg"/"threefry")
                # serialize as raw key data + the impl name
                key_impl = str(jax.random.key_impl(v))
                v = jax.random.key_data(v)
            host[f] = np.asarray(jax.device_get(v))
        for name, arr in state.extras.items():
            host[f"extra.{name}"] = np.asarray(jax.device_get(arr))
        meta = {
            "ts": list(map(float, sim.ts)),
            "seed": int(sim.seed),
            "initial_count": int(sim._initial_count),
            "key_impl": key_impl,
            # high-water slot mark: slots below it may hold dead-but-used
            # history (injections must append past it), and a shrink on
            # restore must not cut into it
            "hwm": int(max(sim._hwm,
                           int(np.asarray(host["n_spawned"])))),
        }
    np.savez_compressed(path, __meta__=json.dumps(meta), **host)


def load_checkpoint(path: str):
    """-> (SimState, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        # t_comp (Kahan clock compensation) is absent in pre-r3 checkpoints;
        # default to zero rather than failing the load
        kw = {f: jnp.asarray(z[f]) for f in _FIELDS if f in z.files}
        if "w" not in kw:  # statistical weights absent pre-weighted-transport
            kw["w"] = jnp.ones(kw["E"].shape, kw["E"].dtype)
        if meta.get("key_impl"):
            kw["key"] = jax.random.wrap_key_data(kw["key"],
                                                 impl=meta["key_impl"])
        kw["extras"] = {
            k[len("extra."):]: jnp.asarray(z[k])
            for k in z.files if k.startswith("extra.")
        }
    return SimState(**kw), meta


def state_from_checkpoint(path: str) -> SimState:
    return load_checkpoint(path)[0]


def repad_state(state: SimState, capacity: int,
                hwm: int | None = None) -> SimState:
    """Re-pad a snapshot's particle axis to ``capacity`` so a checkpoint
    written under one device topology restores under another (r4 VERDICT:
    elastic restart — an 8-chip pod run resumes on 1 or 4 chips and vice
    versa). Growth appends dead slots with the ``SimState.zeros``
    conventions (alive=False, w=1, zeros elsewhere); shrink is legal only
    when it cuts no used slot (nothing alive there and ``hwm`` — the
    injection high-water mark — is below the cut). Clock, PRNG key and
    census scalars ride through untouched, so the resumed physics of the
    surviving slots is identical."""
    cap0 = state.capacity
    if capacity == cap0:
        return state
    planes = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w")
    if capacity < cap0:
        tail_alive = bool(np.asarray(
            jax.device_get(state.alive))[capacity:].any())
        used = cap0 if hwm is None else int(hwm)
        if tail_alive or used > capacity:
            raise ValueError(
                f"cannot shrink checkpoint capacity {cap0} -> {capacity}: "
                f"{'live particles' if tail_alive else 'used slots'} "
                "beyond the cut (restore onto a larger capacity/mesh, or "
                "pass capacity= explicitly)")
        cut = {f: getattr(state, f)[..., :capacity] for f in planes}
        cut["extras"] = {k: v[..., :capacity]
                         for k, v in state.extras.items()}
        return state.replace(**cut)
    pad = capacity - cap0

    def grow(a, fill=0):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return jnp.pad(a, widths, constant_values=fill)

    out = {f: grow(getattr(state, f)) for f in planes if f != "w"}
    out["w"] = grow(state.w, fill=1.0)
    out["extras"] = {k: grow(v) for k, v in state.extras.items()}
    return state.replace(**out)
