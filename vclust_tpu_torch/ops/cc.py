"""Connected components on the device: iterative min-label propagation.

The port of the JAX package's ops/cc.py (`_cc_run`, an XLA program there),
written as torch ops: each round is a scatter-min (`scatter_reduce`,
'amin') of the smaller end label over both edge ends, then two pointer
jumps, repeated until no label changes. Labels converge to the minimum
member index of each component — exactly the host union-find's labels,
and exactly `_cc_run`'s, so the paths are interchangeable.
"""

import numpy as np
import torch

from ..utils.device import resolve_device


def _cc_run(edges: torch.Tensor, n: int) -> torch.Tensor:
    e0, e1 = edges[:, 0], edges[:, 1]
    labels = torch.arange(n, dtype=torch.int64, device=edges.device)
    while True:
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


def connected_components_device(n: int, edges: np.ndarray,
                                device=None) -> np.ndarray:
    """Min-index component label per node; edges (E, 2) int array. Runs
    on `device` (default cuda, see utils/device)."""
    dev = resolve_device(device)
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if len(edges) == 0:
        return np.arange(n, dtype=np.int32)
    e = torch.from_numpy(np.asarray(edges, dtype=np.int64).reshape(-1, 2))
    return _cc_run(e.to(dev), n).to(torch.int32).cpu().numpy()
