from .elucidated import ElucidatedDiffusion
from .gaussian import GaussianDiffusion

__all__ = ["ElucidatedDiffusion", "GaussianDiffusion"]
