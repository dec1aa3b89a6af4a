"""Hand-written CUDA kernels of the port and their plain versions.

``ops`` holds the entry points and launch counts; ``ref`` the plain
PyTorch versions; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
