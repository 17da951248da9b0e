"""Multi-host deployment (JAX distributed).

The scale-out story (SURVEY.md §2.4, BASELINE: >=90% linear scaling to
>=2 hosts): each host feeds its local devices a DISJOINT set of receiver
channels; the steady state has zero cross-host communication (channel
parallelism is embarrassing), so scaling is limited only by per-host
ingest.  Cross-host traffic appears only for:

  * time-sharded offline captures — halo exchange between neighbouring
    time shards (t41x.mesh.halo), kept inside one host by laying the
    mesh out with the `t` axis innermost,
  * global reductions (fleet-wide spectrum/S-meter summaries) — one
    small psum per reporting interval.

Usage on each host:

    from t41x.mesh import distributed as dist
    dist.initialize(coordinator, num_processes, process_id)
    mesh = dist.global_mesh(axis="ch")
    iq_global = dist.shard_local_channels(mesh, local_iq)   # (C_total, N)
    ... channel_sharded_run(chain, mesh, params, iq_global, ...)

All helpers degrade gracefully to single-process (the in-repo tests and
the driver's dry-run exercise exactly that path).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize, skipped when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "ch", time_axis: str | None = None,
                n_time: int = 1) -> Mesh:
    """Mesh over ALL devices (across hosts).  With a time axis, devices
    are laid out (ch, t) with `t` innermost, so halo ppermutes stay
    between the cards of one host; within a host every card reaches
    every other at the same rate, so the mesh follows the algorithm."""
    devs = np.asarray(jax.devices())
    if time_axis is None or n_time <= 1:
        return Mesh(devs, (axis,))
    assert devs.size % n_time == 0
    return Mesh(devs.reshape(devs.size // n_time, n_time),
                (axis, time_axis))


def shard_local_channels(mesh: Mesh, local_iq: np.ndarray,
                         axis: str = "ch"):
    """Assemble the global channel-sharded array from per-host local
    channel blocks (reference-free analog of
    make_array_from_process_local_data)."""
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(local_iq, sharding)
    global_shape = (local_iq.shape[0] * jax.process_count(),
                    *local_iq.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local_iq, global_shape)


def fleet_summary(values):
    """Cross-host reduction of per-channel scalars (e.g. dBm): a jitted
    mean/max/min over the (channel-sharded) global array.  When `values`
    is sharded over hosts, GSPMD lowers these reductions to one
    all-reduce across processes per call (exercised by
    tools/multihost_bench.py); single-process it is a plain reduction."""
    import jax.numpy as jnp

    @jax.jit
    def summarize(v):
        return {"mean": jnp.mean(v), "max": jnp.max(v), "min": jnp.min(v)}

    return summarize(values)
