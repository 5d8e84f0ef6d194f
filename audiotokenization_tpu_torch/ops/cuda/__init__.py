"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers and plain
PyTorch versions, and the nvcc build."""
