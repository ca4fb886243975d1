from .gaussian import GaussianDiffusion

__all__ = ["GaussianDiffusion"]
