from .datasets import (
    BatchLoader,
    ImageFolderDataset,
    SyntheticDataset,
    load_image,
)
from .gmm import (
    calinski_harabasz_score,
    davies_bouldin_score,
    gmm_aic,
    gmm_bic,
    gmm_fit,
    gmm_predict,
    largest_remainder_quotas,
    pca_fit,
    silhouette_score,
    standardize,
    stratified_sample_from_clusters,
)
from .latent_cache import LatentCache, LatentDataset, cache_filename
from .native_image import (
    NativeBatchLoader,
    NativePipeline,
    decode_jpeg_batch,
    loader_kind,
    make_batch_loader,
)
from .native_loader import NativeLatentBatcher
from .prefetch import device_prefetch, to_device
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
           "LatentCache", "LatentDataset", "NativeBatchLoader",
           "NativeLatentBatcher", "NativePipeline", "SyntheticDataset",
           "cache_filename", "calinski_harabasz_score", "create_data_split",
           "davies_bouldin_score", "decode_jpeg_batch", "device_prefetch",
           "gmm_aic", "gmm_bic", "gmm_fit", "gmm_predict",
           "largest_remainder_quotas", "load_image", "load_split",
           "loader_kind", "make_batch_loader", "pca_fit", "save_split",
           "silhouette_score", "standardize",
           "stratified_sample_from_clusters", "to_device",
           "train_images_for_user", "uniform_indices", "verify_split"]
