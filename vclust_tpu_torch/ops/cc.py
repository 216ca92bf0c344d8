"""Connected components on the device: each node labelled with the least
member index of its component.

The port of the JAX package's ops/cc.py (`_cc_run`, an XLA program there).
On CUDA tensors `_cc_run` launches K11 (csrc/cc.cu: union-find on the edge
list, a sample of the edges hooked first and the edges inside the
components it built skipped after, three or five launches, nothing read
back between them); on CPU tensors it
takes `cc_plain`, the min-label propagation written as torch ops: each
round a scatter-min (`scatter_reduce`, 'amin') of the smaller end label
over both edge ends, then two pointer jumps, repeated until no label
changes. Both give exactly the host union-find's labels, and exactly
`_cc_run`'s, so the paths are interchangeable.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cuda

_MAX_NODES = 2 ** 31 - 1


def cc_plain(edges: torch.Tensor, n: int) -> torch.Tensor:
    """K11's plain version: int64 labels from (E, 2) int64 edges.
    `cc_plain.rounds` keeps the rounds of the last call."""
    e0, e1 = edges[:, 0], edges[:, 1]
    labels = torch.arange(n, dtype=torch.int64, device=edges.device)
    cc_plain.rounds = 0
    while True:
        cc_plain.rounds += 1
        m = torch.minimum(labels[e0], labels[e1])
        new = labels.scatter_reduce(0, e0, m, reduce='amin')
        new = new.scatter_reduce(0, e1, m, reduce='amin')
        # Pointer jumping: compress label chains.
        new = new[new]
        new = new[new]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels


cc_plain.rounds = 0


def _cc_run(edges: torch.Tensor, n: int, trusted: bool = False
            ) -> torch.Tensor:
    """K11 wrapper: int32 labels (the least member index of each component)
    from (E, 2) int32 edges, in any orientation, self loops and duplicates
    allowed. CPU tensors take `cc_plain`; CUDA tensors launch K11 or raise.
    K11 loads an edge 8 bytes at a time: on the card the edges must be
    8-byte aligned. Raises for n outside [0, 2^31) and for an edge
    outside [0, n): on the card that check reads the edges' least and
    largest id back to the host before the launch, unless `trusted` (the
    caller has checked the range, as connected_components_device does on
    the host)."""
    dev = edges.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {dev}')
    cuda.require(edges, 'edges', torch.int32, 2, dev)
    if edges.shape[1] != 2:
        raise ValueError(f'edges must be (E, 2), got {tuple(edges.shape)}')
    if not 0 <= n <= _MAX_NODES:
        raise ValueError(f'K11 takes 0 <= n < 2^31 nodes; got {n}')
    if len(edges) and not trusted:
        lo, hi = (int(v) for v in torch.aminmax(edges))
        if lo < 0 or hi >= n:
            raise ValueError(f'edge ids must lie in [0, {n}); got '
                             f'[{lo}, {hi}]')
    if dev.type == 'cpu':
        return cc_plain(edges.long(), n).to(torch.int32)
    if edges.data_ptr() % 8:
        raise ValueError('K11 takes 8-byte aligned edges')
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = cuda.library('cc', cuda.CC_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k11_cc(cuda.ptr(edges), len(edges), n,
                            cuda.ptr(labels), cuda.stream(edges))
        cuda.check(lib, rc, 'k11_cc')
        _cc_run.launches += 1
    return labels


_cc_run.launches = 0


def connected_components_device(n: int, edges: np.ndarray,
                                device=None) -> np.ndarray:
    """Min-index component label per node; edges (E, 2) int array. Runs
    on `device` (default cuda, see utils/device)."""
    dev = resolve_device(device)
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if len(edges) == 0:
        return np.arange(n, dtype=np.int32)
    e = np.asarray(edges).reshape(-1, 2)
    if e.min() < 0 or e.max() >= n:
        raise ValueError(f'edge ids must lie in [0, {n})')
    e = torch.from_numpy(np.ascontiguousarray(e, dtype=np.int32))
    return _cc_run(e.to(dev), n, trusted=True).cpu().numpy()
