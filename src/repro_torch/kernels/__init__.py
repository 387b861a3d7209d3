"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their plain
PyTorch versions, and the autograd wrappers (``ops``) that install them
into the model layers."""
