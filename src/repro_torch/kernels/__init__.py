"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``rmsnorm``, ``flash_attention`` (dense and paged),
``grouped_gemm`` (the MoE expert matmul) and ``ssd_scan`` (the Mamba2
chunked scan).  A wrapper runs the plain version
for a CPU tensor and launches its CUDA kernel (or raises) for a CUDA
tensor; sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels._build` at first use."""
