from .cuda import CUDAAcceleratorManager

__all__ = ["CUDAAcceleratorManager"]
