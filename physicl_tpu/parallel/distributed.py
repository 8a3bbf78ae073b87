"""Multi-host (multi-process) scale-out scaffolding.

The reference is strictly single-device (SURVEY §5: no MPI/NCCL/Gloo
anywhere; one OpenCL queue, physicl/__init__.py:427-432). The distribution
story for independent-photon transport is pure data parallelism over the
particle axis: shard photons over EVERY device of every host, and let XLA
route the measurement psums (NCCL on GPUs: NVLink within a host, the
network between hosts). This module supplies the three pieces a multi-host
launch needs:

1. :func:`init_distributed` — process-group setup (one call per host);
2. :func:`make_pod_mesh` — a 1-D photon mesh over all global devices,
   host-major so that each host's devices are contiguous;
3. multiprocess-aware state placement (``shard_state`` routes here when the
   mesh spans processes).

Launch recipe (one process per host; see docs/distributed.md):

    # host i of N
    physicl_tpu.parallel.init_distributed("host0:1234", N, i)
    mesh = physicl_tpu.parallel.make_pod_mesh()
    sim = Simulation(mesh=mesh, ...)   # identical script on every host

Every process must run the same simulation script (SPMD): populations,
steps, seeds and mid-run injections must match across processes.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

__all__ = ["init_distributed", "make_pod_mesh", "is_multiprocess",
           "mesh_spans_processes", "process_local_slice"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     **kwargs) -> None:
    """Initialize the JAX process group (wraps ``jax.distributed.initialize``).

    Pass the coordinator address (``"host0:port"``), the process count and
    this process's id; on a GPU machine nothing in the environment supplies
    them.
    Safe to call once per process, before any other JAX API touches devices.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def mesh_spans_processes(mesh) -> bool:
    """True iff the mesh includes devices owned by other processes (such
    arrays are not addressable from this host — no device_get, no host-side
    re-placement)."""
    if mesh is None:
        return False
    return any(d.process_index != jax.process_index()
               for d in mesh.devices.reshape(-1))


def make_pod_mesh(devices=None):
    """1-D photon mesh over ALL global devices (every process's devices).

    Ordering is host-major: each host's devices are contiguous in the mesh,
    so only the (tiny) replicated record reductions cross between hosts.
    Single-process: equivalent to :func:`physicl_tpu.parallel.make_mesh`.
    """
    from physicl_tpu.parallel.sharding import PHOTON_AXIS
    from jax.sharding import Mesh

    if devices is None:
        if jax.process_count() > 1:
            devices = np.asarray(sorted(
                jax.devices(), key=lambda d: (d.process_index, d.id)))
        else:
            devices = np.asarray(jax.devices())
    return Mesh(np.asarray(devices).reshape(-1), (PHOTON_AXIS,))


def process_local_slice(mesh, global_shape: tuple) -> tuple:
    """(start, size) of this process's contiguous span of the particle axis.

    Valid for host-major meshes built by :func:`make_pod_mesh`, where
    each process's devices occupy one contiguous block of the 1-D mesh.
    """
    devs = list(mesh.devices.reshape(-1))
    n = len(devs)
    cap = int(global_shape[-1])
    if cap % n:
        raise ValueError(f"capacity {cap} does not divide mesh size {n}")
    per_dev = cap // n
    mine = [i for i, d in enumerate(devs)
            if d.process_index == jax.process_index()]
    if not mine:
        raise ValueError("mesh contains no local devices")
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("pod mesh must be ICI-major (local devices "
                         "contiguous); use make_pod_mesh()")
    return mine[0] * per_dev, len(mine) * per_dev


def fetch_to_every_host(x):
    """``np.asarray`` of a possibly process-spanning record channel.

    Per-photon record channels (plane-crossing E capture) ride the particle
    axis, so on a pod mesh their shards live on other hosts and a plain
    ``device_get`` raises (non-addressable). A compiled identity with a
    replicated out-sharding allgathers the channel so EVERY host assembles
    the identical, complete measurement — the per-particle counterpart of
    the psum'd scalar tallies. Must be called in lockstep on every process
    (the engine's record harvest is — it runs the same loop pod-wide).

    Fully-addressable inputs (single-process meshes, host arrays) pass
    through as a plain fetch: the collective costs nothing when it isn't
    needed.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.sharding import NamedSharding, PartitionSpec

        mesh = getattr(x.sharding, "mesh", None)
        if mesh is None:  # pragma: no cover - pod arrays are NamedSharding
            raise NotImplementedError(
                "cannot replicate a non-addressable array without a mesh "
                f"(sharding {x.sharding!r})")
        x = jax.jit(lambda a: a,
                    out_shardings=NamedSharding(mesh, PartitionSpec()))(x)
    return np.asarray(jax.device_get(x))


def local_shard_np(x):
    """``(host_array, col0)``: this process's contiguous span of a
    particle-axis-sharded array, plus the global index of its first column.

    The shard-local counterpart of :func:`fetch_to_every_host` for channels
    too large to allgather (trace stream buffers: multi-GB per chunk).
    Requires the local shards to be contiguous along the last axis, which
    :func:`make_pod_mesh`'s ICI-major ordering guarantees. Fully-addressable
    inputs fetch whole with ``col0 = 0``.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[-1].start or 0)
        datas = [np.asarray(jax.device_get(s.data)) for s in shards]
        col0 = shards[0].index[-1].start or 0
        off = col0
        for s, d in zip(shards, datas):
            if (s.index[-1].start or 0) != off:
                raise ValueError(
                    "local shards are not contiguous along the particle "
                    "axis; use make_pod_mesh() (ICI-major ordering)")
            off += d.shape[-1]
        return np.concatenate(datas, axis=-1), int(col0)
    return np.asarray(jax.device_get(x)), 0


def shard_state_multiprocess(state, mesh):
    """Place a SimState onto a process-spanning mesh.

    Host-replicated input (initial population; SPMD construction from the
    same seed on every process): each process contributes its local span of
    the particle axis via ``jax.make_array_from_process_local_data`` — no
    cross-host transfer. Arrays that are ALREADY global device arrays
    (mid-run injection updated the pod-sharded state with eager SPMD ops)
    cannot be fetched to host; they are resharded in place by a compiled
    identity with the target shardings — every process executes it in
    lockstep (guaranteed by the consensus-gated edit application,
    population.py:check_divergence).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from physicl_tpu.parallel.sharding import PHOTON_AXIS

    rep = NamedSharding(mesh, P())
    cap = state.capacity

    def place(x):
        sharded = (getattr(x, "ndim", 0) > 0 and x.shape[-1] == cap)
        if sharded:
            spec = P(*([None] * (x.ndim - 1) + [PHOTON_AXIS]))
            target = NamedSharding(mesh, spec)
        else:
            target = rep
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return jax.jit(lambda a: a, out_shardings=target)(x)
        x_np = np.asarray(jax.device_get(x))
        if not sharded:
            return jax.make_array_from_process_local_data(rep, x_np,
                                                          x_np.shape)
        start, size = process_local_slice(mesh, x_np.shape)
        return jax.make_array_from_process_local_data(
            target, x_np[..., start:start + size], x_np.shape)

    return state.replace(
        r=place(state.r), dr=place(state.dr), v=place(state.v),
        dv=place(state.dv), a=place(state.a), E=place(state.E),
        alive=place(state.alive), otype=place(state.otype),
        w=place(state.w),
        t=place(state.t), dt=place(state.dt), key=place(state.key),
        n_spawned=place(state.n_spawned), t_comp=place(state.t_comp),
        extras={k: place(v) for k, v in state.extras.items()},
    )
