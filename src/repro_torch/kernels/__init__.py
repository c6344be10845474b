"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``rmsnorm`` and dense ``flash_attention``.  A wrapper runs the
plain version for a CPU tensor and launches its CUDA kernel (or raises) for
a CUDA tensor; sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels._build` at first use."""
