"""Multi-process (multi-host) runtime for domain decomposition.

The reference scales across nodes with MPI (dd_init c:2193,
MPI_Alltoallv exchange c:2072-2193); the JAX equivalent is JAX's
multi-controller runtime: every process calls
:func:`init_distributed`, after which ``jax.devices()`` spans all
processes and the existing ``shard_map`` DD step (parallel.dd) runs
unchanged — XLA lowers ``lax.all_to_all`` onto NCCL collectives
between processes instead of intra-process transfers.

Each process:
- reads only its own subdomain's met hyperslab (dd.read_met_tile),
- holds only its parcel shard,
- assembles *global* jax.Arrays from the local shards
  (:func:`globalize`), so the jitted step sees one logical array.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int,
                     local_devices: Optional[int] = None) -> None:
    """Join the multi-controller runtime (reference dd_init's
    MPI_Init analog).  Call before any other JAX operation; with
    ``local_devices`` on CPU it pins the per-process virtual device
    count (e.g. 1 device per process for an MPI-rank-like layout)."""
    if local_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_devices)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "sub") -> Mesh:
    """One mesh over every device of every process."""
    return Mesh(np.array(jax.devices()), (axis,))


def globalize(mesh: Mesh, local_tree, spec_tree=None,
              axis: str = "sub"):
    """Turn per-process host shards into global device arrays.

    ``local_tree`` holds THIS process's block of each leaf;
    ``spec_tree`` gives the PartitionSpec per leaf (default: shard the
    leading dimension along ``axis``).  Dimensions named in the spec
    are process-local blocks of a ``factor``-times-larger global
    dimension; unnamed dimensions are replicated."""
    factor = mesh.devices.size // max(len(mesh.local_devices), 1)
    if spec_tree is None:
        spec_tree = jax.tree.map(lambda x: P(axis), local_tree)

    def one(x, spec):
        x = np.asarray(x)
        gshape = list(x.shape)
        for i, name in enumerate(spec):
            if name is not None and i < len(gshape):
                gshape[i] *= factor
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(
            sharding, x, tuple(gshape))

    return jax.tree.map(one, local_tree, spec_tree,
                        is_leaf=lambda t: isinstance(t, P))


def localize(tree):
    """Fetch THIS process's shards of global arrays back to host
    numpy (concatenated along the leading axis)."""
    def one(x):
        shards = [s for s in x.addressable_shards]
        shards.sort(key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards],
                              axis=0)
    return jax.tree.map(one, tree)


def read_met_shared(filename: str, ctl, clim=None):
    """MET_MPI_SHARE analog (reference c:45-70, 7528-7540): process 0
    reads + preprocesses the met snapshot, every other process
    receives the finished fields via a broadcast instead of touching
    the filesystem — for shared filesystems that collapse under
    N-process reads."""
    from jax.experimental import multihost_utils

    from mptrac_tpu.met.build import read_met
    from mptrac_tpu.types import Met

    import json as _json

    if jax.process_index() == 0:
        met = read_met(filename, ctl, clim)
        leaves, _ = jax.tree.flatten(jax.tree.map(np.asarray, met))
        shapes = [(list(x.shape), str(x.dtype)) for x in leaves]
        meta = dict(shapes=shapes, npl_ml=int(met.npl_ml),
                    coord_type=int(met.coord_type))
        payload = np.frombuffer(
            _json.dumps(meta).encode().ljust(65536), np.uint8).copy()
    else:
        leaves = None
        payload = np.zeros(65536, np.uint8)
    meta = _json.loads(bytes(np.asarray(
        multihost_utils.broadcast_one_to_all(payload))).decode()
        .rstrip("\x00").strip())
    # one collective per leaf keeps peak memory at a single field
    out_leaves = []
    for i, (shape, dtype) in enumerate(meta["shapes"]):
        src = (leaves[i] if leaves is not None
               else np.zeros(shape, dtype))
        out_leaves.append(np.asarray(
            multihost_utils.broadcast_one_to_all(jnp.asarray(src))))
    # Met's pytree structure is deterministic (dict keys sorted by
    # jax.tree), so a skeleton with the same key sets and aux values
    # unflattens process 0's leaves on every rank
    from mptrac_tpu.types import MET_2D_FIELDS, MET_3D_FIELDS, Met
    skel = Met(time=0, lon=0, lat=0, p=0, hybrid=0,
               fields2d={k: 0 for k in MET_2D_FIELDS},
               fields3d={k: 0 for k in MET_3D_FIELDS},
               coord_type=meta["coord_type"], npl_ml=meta["npl_ml"])
    return jax.tree.unflatten(jax.tree.structure(skel), out_leaves)


def allsum_scalar(x: float) -> float:
    """Sum a host scalar over processes (diagnostic counters)."""
    from jax.experimental import multihost_utils
    return float(multihost_utils.process_allgather(
        jnp.asarray([x])).sum())
