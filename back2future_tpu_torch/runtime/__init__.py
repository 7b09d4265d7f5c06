"""Native runtime of the port: the CUDA kernel library and its launchers."""

from .cuda_build import KERNELS, Kernel, build, reset_launches

__all__ = ["KERNELS", "Kernel", "build", "reset_launches"]
