"""vclust-tpu on PyTorch and CUDA: ANI computation and clustering of viral
genomes, with the device work on an NVIDIA GPU.

The port of the JAX package that sits beside it: the same CLI surface and
byte-compatible output files. It imports torch and never JAX; its entry
points run on `cuda` unless the caller asks for the CPU (`device='cpu'`,
or `VCLUST_TORCH_DEVICE=cpu` for the CLI), and raise when CUDA is missing
rather than carry on on the CPU. The hand-written CUDA kernels live in
`csrc/` and are built with nvcc at first use (ops/cuda.py).

Public constants mirror the reference's module-level API surface
(reference vclust.py:38-47).
"""

__version__ = '0.1.0'

from .utils.alloc import tune_host_allocator as _tune_host_allocator

_tune_host_allocator()

CITATION = (
    'vclust-tpu: reimplementation of Vclust '
    '(Zielezinski A, Gudys A et al. (2025) Nat Methods, '
    'doi:10.1038/s41592-025-02701-7)'
)

# Columns emitted by the alignment stage (reference vclust.py:38-41).
ALIGN_FIELDS = [
    'qidx', 'ridx', 'query', 'reference', 'tani', 'gani', 'ani', 'qcov',
    'rcov', 'num_alns', 'len_ratio', 'qlen', 'rlen', 'nt_match', 'nt_mismatch',
]

# Output format presets (reference vclust.py:43-47).
ALIGN_OUTFMT = {
    'lite': ALIGN_FIELDS[:2] + ALIGN_FIELDS[4:11],
    'standard': ALIGN_FIELDS[:11],
    'complete': ALIGN_FIELDS[:],
}
