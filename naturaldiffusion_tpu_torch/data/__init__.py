"""Host data paths of the port: the dataset iterators of training, the
batch loader, the TFRecord reader and the image-folder preprocessing."""

from .datasets import (get_dataset, cifar10_iterator, synthetic_iterator,
                       get_scaler, get_inverse_scaler)
from .image_folder import list_images, preprocess_image
from .native_loader import NativeBatchLoader

__all__ = ["get_dataset", "cifar10_iterator", "synthetic_iterator",
           "get_scaler", "get_inverse_scaler", "NativeBatchLoader",
           "list_images", "preprocess_image"]
