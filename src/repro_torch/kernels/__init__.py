"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch
versions, dispatched by device in :mod:`repro_torch.kernels.ops`."""
