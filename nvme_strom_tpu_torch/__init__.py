"""PyTorch/CUDA port of nvme_strom_tpu for one NVIDIA H100.

The NVMe→GPU stream (io/, ops/bridge.py), safetensors weights
(parallel/weights.py) and continuous-batching decode (models/) of the
JAX package, with its TPU kernels rewritten by hand for Hopper
(csrc/*.cu, built at first use by _build.py).  The package imports
torch, numpy and the standard library only.  Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``.
"""
