"""Hand-written CUDA kernels (built from ``repro_torch/csrc`` at first use)
with their plain PyTorch versions, one package per TPU kernel family."""
