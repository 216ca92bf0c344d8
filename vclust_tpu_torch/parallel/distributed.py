"""Multi-process runtime: a torch.distributed process group, global meshes
and host gathers.

The port of the JAX package's parallel/distributed.py. The reference is
single-node (SURVEY.md L4: "no distributed runtime"); this is the
scale-out layer: one process per host, a mesh spanning every process's
devices (`global_mesh`), the pair grid cut among the shards so each
device works on its own part (ops/prefilter.py, ops/align_gpu.py), and the
results gathered on the host.

Environment contract (one process per host):

    VCLUST_DIST_COORD   coordinator address, e.g. "10.0.0.1:9911"
    VCLUST_DIST_NPROCS  total number of processes
    VCLUST_DIST_PROCID  this process's id (0-based)

`maybe_initialize()` is a no-op unless all three are set, so single-host
use is unchanged. The group is gloo's and every collective here moves host
tensors: the compute stays on the devices, and the results end on the host
as numpy arrays, as the JAX package's do. (Gloo also lets several
processes share one card, which NCCL refuses.) A collective that waits
longer than the group's timeout raises.

Run by `python -m vclust_tpu_torch.parallel.worker` (tests/
test_torch_multihost.py: 2 processes x 2 CPU shards; chip_smoke.py: 2
processes on one card).
"""

import datetime
import os
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, _indexed, make_mesh

ENV_VARS = ('VCLUST_DIST_COORD', 'VCLUST_DIST_NPROCS', 'VCLUST_DIST_PROCID')


def maybe_initialize(timeout: float = 300.0) -> bool:
    """Join the process group of the environment contract (gloo, over
    tcp://VCLUST_DIST_COORD), its collectives failing after `timeout`
    seconds. Returns True when running multi-process."""
    coord, nprocs, procid = (os.environ.get(k) for k in ENV_VARS)
    if not (coord and nprocs and procid):
        return False
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(
            'gloo', init_method=f'tcp://{coord}', world_size=int(nprocs),
            rank=int(procid), timeout=datetime.timedelta(seconds=timeout))
    return True


def process_info() -> Optional[tuple]:
    """(process_id, num_processes) when distributed, else None."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return dist.get_rank(), dist.get_world_size()


def global_mesh(devices=None) -> Mesh:
    """1-D mesh over every shard of every process of the group: this
    process's `devices` (default its visible cards), shards ranked
    process-major. Every process must hold as many shards."""
    import torch.distributed as dist
    if process_info() is None:
        raise RuntimeError('no multi-process group: call maybe_initialize()')
    local = (make_mesh().devices if devices is None else
             tuple(_indexed(torch.device(d)) for d in devices))
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f'processes hold unequal shard counts {counts}')
    return Mesh(local, dist.group.WORLD)


def gather(mesh: Optional[Mesh], obj) -> list:
    """Every process's `obj` in rank order ([obj] without a group)."""
    if mesh is None or mesh.group is None:
        return [obj]
    import torch.distributed as dist
    out = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def fetch(parts, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Host copy of a tensor, or of this process's shard parts (tensors or
    arrays, in shard order) joined along axis 0 with every other
    process's, in shard order."""
    if torch.is_tensor(parts):
        return parts.cpu().numpy()
    local = [p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p)
             for p in parts]
    return np.concatenate([p for ps in gather(mesh, local) for p in ps])


def reduce_sum(mesh: Optional[Mesh], x: np.ndarray) -> np.ndarray:
    """The sum of `x` over the mesh's processes (x itself without a
    group)."""
    if mesh is None or mesh.group is None:
        return x
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.all_reduce(t, group=mesh.group)
    return t.numpy()


def replicate(mesh: Mesh, x) -> dict:
    """`x` placed once on each distinct device of this process's shards:
    {device: copy}. x is a tensor or a dict (its tensors placed, other
    values kept); a tensor is not copied to the device it is on."""
    def to(d, v):
        if isinstance(v, dict):
            return {k: to(d, u) for k, u in v.items()}
        return v.to(d) if torch.is_tensor(v) else v
    return {d: to(d, x) for d in dict.fromkeys(mesh.devices)}
