# Meshes of devices and the multi-process runtime (torch.distributed).
