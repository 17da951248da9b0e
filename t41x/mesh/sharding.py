"""Mesh construction and channel sharding (JAX).

The reference is a single receiver on a single core; t41x's scale-out
model (SURVEY.md §2.4, §7 phase 6) is:

  * `ch` mesh axis — embarrassingly-parallel channel parallelism (the
    "data parallel" axis): each device owns a disjoint set of receiver
    channels.  No collectives in the steady state.
  * `t` mesh axis — time-block sharding for offline/batch captures (the
    "sequence parallel" axis): consecutive time segments on neighboring
    devices, with overlap-save filter history exchanged via `ppermute`
    (see t41x.mesh.halo).

Channel sharding runs the chain under `shard_map`: each device holds
and computes only its own channels, hand kernels included; nothing in
the chain mixes channels, so the compiled program has zero cross-device
communication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from t41x import constants as C


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def _sharded_scan(chain, mesh: Mesh, axis: str, params, blocks, state):
    """Scan `chain.block` over (n_blocks, C, BLOCK) blocks with every
    device running its own slice of the channels (`shard_map`: each
    device holds and computes only its channels, kernels included).
    Returns (state, audio_24k (n_blocks, C, 256)), channel-sharded."""
    def local(blocks, st, params):
        def step(st, blk):
            st, out = chain.block(params, st, blk)
            return st, out["audio_24k"]

        return jax.lax.scan(step, st, blocks)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, axis), P(axis), P(axis)),
        out_specs=(P(axis), P(None, axis)), check_vma=False,
    )(blocks, state, params)


def channel_sharded_run(chain, mesh: Mesh, params, iq, n_blocks: int,
                        axis: str = "ch"):
    """Run the chain's scan-over-blocks with the channel axis sharded over
    `mesh`.  iq: (C, n_blocks*BLOCK) complex.  Returns audio_24k
    (C, n_blocks*256), channel-sharded."""
    _, audio = channel_sharded_stream(
        chain, mesh, params, iq[:, : n_blocks * C.BLOCK_SIZE], axis=axis)
    return audio


def channel_sharded_stream(chain, mesh: Mesh, params, iq, state=None,
                           axis: str = "ch"):
    """Resumable channel-sharded execution: accepts and returns the carry
    state, so a stream can be checkpointed and CONTINUED — including on a
    DIFFERENT device count (elastic recovery, SURVEY.md §5: per-host
    failure = re-shard channels).  The host-resident state is device_put
    with THIS mesh's sharding, so a checkpoint taken on an 8-device mesh
    resumes on 4 (or 1) unchanged.

    iq: (C, n_blocks*BLOCK) complex.  Returns (state, audio_24k).
    """
    n_ch = iq.shape[0]
    n_blocks = iq.shape[1] // C.BLOCK_SIZE
    spec_data = NamedSharding(mesh, P(axis))

    blocks = iq[:, : n_blocks * C.BLOCK_SIZE].reshape(
        n_ch, n_blocks, C.BLOCK_SIZE)
    blocks = jnp.moveaxis(blocks, 1, 0)

    if state is None:
        state = chain.init_state((n_ch,))
    # every state leaf has a leading channel dim -> shard dim 0 on the
    # (possibly different-sized) target mesh
    state = jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), spec_data), state)

    @jax.jit
    def run(blocks, state, params):
        st, audio = _sharded_scan(chain, mesh, axis, params, blocks, state)
        return st, jnp.moveaxis(audio, 0, 1).reshape(n_ch, -1)

    blocks = jax.device_put(blocks, NamedSharding(mesh, P(None, axis)))
    params = jax.device_put(params, spec_data)
    return run(blocks, state, params)
