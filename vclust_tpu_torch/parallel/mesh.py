"""A 1-D mesh of devices for the all-vs-all pair grid.

The port of the JAX package's parallel/mesh.py. A `Mesh` lists the devices
of this process's shards, in shard order. One device may hold several
shards, so one card, or the CPU, can stand in for an n-device mesh. A mesh
from `distributed.global_mesh` spans the processes of a process group:
each process holds as many shards, ranked process-major, and results are
gathered on the host (parallel/distributed.py).

What runs over a mesh:
- K1's pair counts (ops/prefilter.py, `shared_kmer_counts_indexed(mesh=)`):
  each pass's work list is cut among the shards, the shards of a device
  add into one counts there, and the devices' counts are added on the
  first device;
- the device align engine (ops/align_gpu.py, `all2all_gpu(mesh=)`): the
  dispatches are dealt to the shards in turn, and each group's arena is
  copied once to each distinct device;
- the dense products below: each shard's row block of occ occ^T against
  every row, as int8 operands with int32 sums (`int_products`).

The CLI runs on one card even where several are visible (the JAX
package's CLI takes `auto_mesh()`): on four H100s, `prefilter` on 192
genomes and `align --engine gpu` on 48 and 192 took as long or longer in
a process over all four cards as in one that saw one card. Each further
card starts its context and loads its kernels before it works, and at
these sizes that costs what the cards save.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    devices: tuple           # torch.device of each of this process's shards
    group: Optional[object] = None   # the process group spanned, if any


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index (cuda -> cuda:<current>), so devices compare."""
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of this process alone. device None: the visible cards, all of
    them or the first n_devices (raises without CUDA or with fewer cards).
    A device (e.g. 'cpu', 'cuda:0'): n_devices shards (default 1), all on
    it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available; pass device="cpu" '
                               'for a mesh of CPU shards')
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f'{n} devices asked for, {count} visible')
        devices = [torch.device('cuda', i) for i in range(n)]
    else:
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f'a mesh needs a shard, got {n}')
        devices = [_indexed(resolve_device(device))] * n
    return Mesh(tuple(devices))


def auto_mesh() -> Optional[Mesh]:
    """Mesh over all visible cards, or None when fewer than two are
    present."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def local_shards(mesh: Mesh):
    """([(shard, device), ...] of this process, the mesh's shard count)."""
    rank, world = 0, 1
    if mesh.group is not None:
        import torch.distributed as dist
        rank = dist.get_rank(mesh.group)
        world = dist.get_world_size(mesh.group)
    k = len(mesh.devices)
    return [(rank * k + i, d) for i, d in enumerate(mesh.devices)], world * k


def int_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (n, k)^T for int8 a and b, with int32 sums (exact for
    {0,1} operands up to 2^31 - 1), through torch._int_mm, whose CUDA path
    wants m > 16 and k, n multiples of 8: the operands are padded with
    zeros and the product cut back."""
    m, k = a.shape
    n = b.shape[0]
    kp = max(8, -(-k // 8) * 8)
    a = torch.nn.functional.pad(a, (0, kp - k, 0, max(m, 17) - m))
    b = torch.nn.functional.pad(b, (0, kp - k, 0, -(-n // 8) * 8 - n))
    return torch._int_mm(a, b.t())[:m, :n]


def ani_shorter_f32(counts: torch.Tensor, row_sizes: torch.Tensor,
                    col_sizes: torch.Tensor, k: int) -> torch.Tensor:
    """kmer-db's ani-shorter of int counts in float32, as the JAX package's
    dense prefilter step computes it: c = counts / max(min(|A|, |B|), 1),
    1 + ln(2c / (1 + c)) / k (-inf where counts is 0)."""
    min_sz = torch.minimum(row_sizes.float()[:, None],
                           col_sizes.float()[None, :])
    c = counts.float() / torch.clamp(min_sz, min=1.0)
    return 1.0 + torch.log(2.0 * c / (1.0 + c)) / k


def _row_blocks(mesh: Mesh, occ):
    """Each of this process's shards' row block of occ occ^T: [(shard, rows
    of the block, int32 counts on the shard's device), ...]."""
    occ = torch.as_tensor(np.asarray(occ) if not torch.is_tensor(occ)
                          else occ).to(torch.int8)
    shards, n_shards = local_shards(mesh)
    G = occ.shape[0]
    if G % n_shards:
        raise ValueError(f'{G} rows do not divide among {n_shards} shards')
    per = G // n_shards
    on = {}
    out = []
    for s, dev in shards:
        occ_d = on.setdefault(dev, occ.to(dev))
        rows = slice(s * per, (s + 1) * per)
        out.append((s, rows, int_products(occ_d[rows], occ_d)))
    return out


def sharded_pair_counts(mesh: Mesh, occ) -> np.ndarray:
    """counts = occ @ occ.T with the genome axis sharded over the mesh.

    occ: (G, M) {0,1} occupancy (numpy or tensor, the same in every
    process), G divisible by the mesh's shard count. Each shard computes
    its row block against every row on its device; the blocks are joined
    in shard order on the host (over the processes too). Returns int32
    (G, G)."""
    from .distributed import fetch
    return fetch([c for _, _, c in _row_blocks(mesh, occ)], mesh)


def sharded_prefilter_step(mesh: Mesh, occ, sizes, k: int, min_ident: float,
                           min_kmers: int):
    """The sharded prefilter step: pair counts, ani-shorter in float32 and
    the thresholds (counts >= min_kmers, sim >= min_ident, col < row), each
    shard on its row block; returns (counts int32 (G, G), keep bool (G, G),
    n_candidates), the candidates summed over the shards."""
    from .distributed import fetch, reduce_sum
    sizes = torch.as_tensor(np.asarray(sizes)).float()
    G = sizes.shape[0]
    counts, keeps, n_local = [], [], 0
    for _, rows, c in _row_blocks(mesh, occ):
        dev = c.device
        sz = sizes.to(dev)
        sim = ani_shorter_f32(c, sz[rows], sz, k)
        row_ids = torch.arange(rows.start, rows.stop, device=dev)[:, None]
        col_ids = torch.arange(G, device=dev)[None, :]
        keep = (c >= min_kmers) & (sim >= min_ident) & (col_ids < row_ids)
        counts.append(c)
        keeps.append(keep)
        n_local += int(keep.sum())
    n_total = int(reduce_sum(mesh, np.array([n_local], np.int64))[0])
    return fetch(counts, mesh), fetch(keeps, mesh), n_total
