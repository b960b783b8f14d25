"""Hand-written CUDA kernels of the port (csrc/) with their plain PyTorch
versions (ref.py) and the public entry points (ops.py)."""
