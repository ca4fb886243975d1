from .datasets import BatchLoader, ImageFolderDataset, load_image
from .latent_cache import LatentCache, LatentDataset, cache_filename
from .splits import (
    IMAGE_EXTENSIONS,
    create_data_split,
    load_split,
    save_split,
    train_images_for_user,
    uniform_indices,
    verify_split,
)

__all__ = ["BatchLoader", "IMAGE_EXTENSIONS", "ImageFolderDataset",
           "LatentCache", "LatentDataset", "cache_filename",
           "create_data_split", "load_image", "load_split", "save_split",
           "train_images_for_user", "uniform_indices", "verify_split"]
