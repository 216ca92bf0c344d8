"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks otherwise: a `device=`
argument, or for the CLI the `VCLUST_TORCH_DEVICE` environment variable.
With no CUDA and no explicit request for the CPU they raise: the port
never falls back to the CPU by itself.
"""

import os

import torch

ENV_VAR = 'VCLUST_TORCH_DEVICE'


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (see module docstring)."""
    if device is None:
        device = os.environ.get(ENV_VAR) or 'cuda'
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" (or set '
            f'{ENV_VAR}=cpu) to run on the CPU')
    return dev
