"""Host data paths of the port: the batch loader of the FID statistics
pipeline, and the image-folder preprocessing of the degradation study."""

from .image_folder import list_images, preprocess_image
from .native_loader import NativeBatchLoader

__all__ = ["NativeBatchLoader", "list_images", "preprocess_image"]
