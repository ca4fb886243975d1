from .classifier import ClassifierExperiment, run_multi_seed
from .fid import FIDEvaluation, FIDStats, frechet_distance
from .metrics import mse, psnr, ssim, ssim_simplified
from .tsne import embed_user_features, select_extreme_users, tsne

__all__ = ["ClassifierExperiment", "FIDEvaluation", "FIDStats",
           "embed_user_features", "frechet_distance", "mse", "psnr",
           "run_multi_seed", "select_extreme_users", "ssim",
           "ssim_simplified", "tsne"]
