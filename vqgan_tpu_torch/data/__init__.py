from .datasets import BatchLoader, ImageFolderDataset, load_image
from .latent_cache import LatentCache, LatentDataset, cache_filename
from .splits import load_split, save_split, train_images_for_user

__all__ = ["BatchLoader", "ImageFolderDataset", "load_image", "LatentCache", "LatentDataset",
           "cache_filename", "load_split", "save_split",
           "train_images_for_user"]
