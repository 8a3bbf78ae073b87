"""Particle-axis sharding over a device mesh.

Design (SURVEY.md §2 "Parallelism strategies", §5 "Distributed communication"):
the only compute parallelism the physics admits is data parallelism over
independent photons — the reference's one-OpenCL-work-item-per-photon global
size (physicl/__init__.py:640-644), lifted from one device to a mesh. State
lives sharded in each device's memory; per-iteration physics is
embarrassingly parallel; measurement reductions (counts, sign tallies, plane
crossings) become psum collectives, which XLA hands to NCCL on GPUs;
host<->device traffic stays at init and final readback. GPUs of one host are
joined all to all, so a 1-D mesh over the photon axis is the whole layout.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from physicl_tpu.state import SimState

PHOTON_AXIS = "photons"

__all__ = ["make_mesh", "particle_sharding", "shard_state", "PHOTON_AXIS",
           "build_sharded_fused"]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the photon axis (the complete distribution story for
    independent-particle transport)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: int(n_devices)]
    return Mesh(np.array(devices), (PHOTON_AXIS,))


def particle_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for an array whose LAST axis is the particle axis."""
    spec = P(*([None] * (ndim - 1) + [PHOTON_AXIS]))
    return NamedSharding(mesh, spec)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place SimState with the particle axis sharded across the mesh.

    Scalars (t, dt, key) are replicated. Capacity must divide the mesh size
    (the engine pads for this). Meshes spanning multiple processes route
    through the multi-host placement path (each process contributes its
    local span — no cross-host transfer).
    """
    from physicl_tpu.parallel.distributed import (
        mesh_spans_processes,
        shard_state_multiprocess,
    )

    if mesh_spans_processes(mesh):
        return shard_state_multiprocess(state, mesh)
    rep = NamedSharding(mesh, P())

    def place(x, ndim_particle):
        if x.ndim == 0 or x.shape[-1] != state.capacity:
            return jax.device_put(x, rep)
        return jax.device_put(x, particle_sharding(mesh, x.ndim))

    return state.replace(
        r=place(state.r, 2), dr=place(state.dr, 2), v=place(state.v, 2),
        dv=place(state.dv, 2), a=place(state.a, 2), E=place(state.E, 1),
        alive=place(state.alive, 1), otype=place(state.otype, 1),
        w=place(state.w, 1),
        extras={n: place(x, x.ndim) for n, x in state.extras.items()},
        t=jax.device_put(state.t, rep), dt=jax.device_put(state.dt, rep),
        key=jax.device_put(state.key, rep),
        n_spawned=jax.device_put(state.n_spawned, rep),
        t_comp=jax.device_put(state.t_comp, rep),
    )


def build_sharded_fused(plan, capacity: int, mesh: Mesh):
    """Fused transport chunk under shard_map: each shard advances its local
    photons K iterations with the plan's builder; record rows cross devices
    as one psum.

    Matches build_fused_chunk's signature: (packed (15,C), dts, emit_starts, seed, k_act)
    -> (packed, rec). Seeds are decorrelated per shard via axis_index.
    """
    from jax import shard_map
    from physicl_tpu.ops import fused as F

    n_shards = mesh.devices.size
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} not divisible by mesh size {n_shards}")
    local_cap = capacity // n_shards
    kern = F.build_fused_chunk(plan, local_cap)

    def per_shard(packed_l, dts, emit_starts, seed, k_act):
        idx = jax.lax.axis_index(PHOTON_AXIS)
        seed_l = (seed + (idx + 1) * jnp.int32(97003)) & jnp.int32(0x7FFFFFFF)
        # emitter slot starts are global; shift into shard-local coordinates
        # (windows crossing a shard boundary are written piecewise)
        emit_l = emit_starts - idx.astype(jnp.int32) * jnp.int32(local_cap)
        res = kern(packed_l, dts, emit_l, seed_l, k_act)
        out_l, rec_l, recf_l = res[0], res[1], res[2]
        rec = jax.lax.psum(rec_l, PHOTON_AXIS)
        rec_f = jax.lax.psum(recf_l, PHOTON_AXIS)
        if plan.n_stream:  # per-photon planes stay sharded with the photons
            return out_l, rec, rec_f, res[3]
        return out_l, rec, rec_f

    out_specs = (P(None, PHOTON_AXIS), P(), P())
    if plan.n_stream:
        out_specs = out_specs + (P(None, None, PHOTON_AXIS),)
    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(None, PHOTON_AXIS), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def run(packed, dts, emit_starts, seed, k_act):
        return sharded(packed, jnp.asarray(dts, jnp.float32),
                       jnp.asarray(emit_starts, jnp.int32),
                       jnp.asarray(seed, jnp.int32),
                       jnp.asarray(k_act, jnp.int32))

    return run
