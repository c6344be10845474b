"""PyTorch/CUDA port of the Moirai serving system (``repro``'s JAX
reference stays the yardstick).  Host-side modules (``configs``, ``core``,
``serving.adaptation``, ``serving.kv_pool``) are copies of the reference's
with ``repro.`` rewritten to ``repro_torch.``; the model, serving executor,
engine and launcher are ports; attention and RMSNorm run through the
hand-written Hopper kernels in ``kernels``/``csrc``.  Nothing here imports
JAX or ``repro``."""
