"""Device mesh construction + device discovery (SURVEY.md C10).

The reference prints the best CUDA device (``basicCudaDeviceInformation``,
``Kernel.cu:986-1000``); the equivalent here reports the JAX device
topology and builds the 1-D chains mesh the samplers shard over. For
multi-host pods the same helpers work on top of ``jax.distributed``.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


CHAINS_AXIS = "chains"


def chain_mesh(n_devices: int | None = None, axis: str = CHAINS_AXIS) -> Mesh:
    """1-D mesh over (up to) all addressable devices, chains sharded along it."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


def chain_sharding(mesh: Mesh, axis: str = CHAINS_AXIS) -> NamedSharding:
    """Sharding for a chains-leading array (chains split, rest replicated)."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def to_varying(tree, axis: str = CHAINS_AXIS):
    """Mark a pytree device-varying along ``axis`` (no-op for varying leaves).

    shard_map's varying-manual-axes check requires scan carries / cond
    branches to have consistent varying types; values derived from
    replicated inputs must be pcast before a scan body makes them vary.
    """

    def cast(a):
        vma = getattr(jax.typeof(a), "vma", frozenset())
        if axis in vma:
            return a
        return jax.lax.pcast(a, (axis,), to="varying")

    return jax.tree.map(cast, tree)


def device_report() -> str:
    """Human-readable device/mesh report (C10 equivalent)."""
    lines = []
    backend = jax.default_backend()
    lines.append(f"backend: {backend}")
    lines.append(
        f"process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )
    for d in jax.local_devices():
        kind = getattr(d, "device_kind", "?")
        lines.append(f"  device {d.id}: {d.platform} ({kind})")
    return "\n".join(lines)
