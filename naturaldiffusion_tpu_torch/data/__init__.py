"""Host data paths of the port: the batch loader of the FID statistics
pipeline."""

from .native_loader import NativeBatchLoader

__all__ = ["NativeBatchLoader"]
