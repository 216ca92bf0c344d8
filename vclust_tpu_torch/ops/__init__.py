# Device ops (torch, with CUDA kernels from csrc/) and host engines.
