"""Hand-written CUDA kernels of the port, one package per TPU kernel it
replaces: ``ops.py`` (checked wrapper and launch count), ``ref.py`` (the
plain PyTorch version), CUDA sources under ``repro_torch/csrc/``."""
