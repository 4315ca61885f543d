"""Hand-written CUDA kernels (csrc/*.cu), their ctypes wrappers, plain
PyTorch versions, and the device-dispatching wrappers in ops.py."""
