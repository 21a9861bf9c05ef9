"""The engine's compute-group mesh (the JAX package's
``launch/mesh.make_group_mesh``) on ``torch.distributed``.

Axes, in the JAX package's canon:

  group  asynchronous compute groups (paper §IV-A round-robin staleness)
  data   synchronous data parallelism within a group
  mp     model parallelism within a worker (param/momentum shards)

The JAX package's production and host-smoke meshes exist for its XLA
dry-run; the port's dry-run (``launch.dryrun``) reckons on meta tensors
over a layout given as axis sizes, ``{"group": g, "data": k, "mp": mp}``,
and makes no mesh.
"""
from __future__ import annotations

#: canonical engine mesh axes (model-parallel axis last)
GROUP_MESH_AXES = ("group", "data", "mp")


def make_group_mesh(groups: int, data: int = 1, mp: int = 1, *,
                    device_type: str = "cuda"):
    """(g, k, mp) ``DeviceMesh`` over the first g·k·mp ranks of the
    initialized process group, with axes ("group", "data", "mp"): g compute
    groups of k synchronous workers, each worker ``mp`` ranks holding one
    shard of the parameters and momentum. Rank r < g·k·mp sits at
    ``(r // (k·mp), r // mp % k, r % mp)``; ranks past the mesh are
    outside it (``get_coordinate()`` is None) and run no step, as the JAX
    package leaves the devices past its mesh idle. Every rank of the
    world calls this: the mesh's process groups are made collectively."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("the group mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    n = groups * data * mp
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a ({groups},{data},{mp}) group mesh needs {n} "
                         f"ranks, the world has {world}")
    if world == n:
        return init_device_mesh(device_type, (groups, data, mp),
                                mesh_dim_names=GROUP_MESH_AXES)
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(groups, data, mp),
                      mesh_dim_names=GROUP_MESH_AXES)
