"""PyTorch/CUDA port of the OmniRouter/ECCOS routing plane.

A second package beside ``repro`` (the JAX reference), mirroring its
module layout file for file.  It imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``repro``.  Entry points run on
``torch.device("cuda")`` unless the caller passes ``device="cpu"``; on a
CUDA tensor every kernel module launches its hand-written CUDA kernel
(``repro_torch/csrc``) or raises, and on a CPU tensor it runs its plain
PyTorch version.
"""
