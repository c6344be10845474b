"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``rmsnorm``, ``flash_attention`` (dense and paged) and
``grouped_gemm`` (the MoE expert matmul).  A wrapper runs the plain version
for a CPU tensor and launches its CUDA kernel (or raises) for a CUDA
tensor; sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels._build` at first use."""
