from .metrics import mse, psnr, ssim, ssim_simplified

__all__ = ["mse", "psnr", "ssim", "ssim_simplified"]
