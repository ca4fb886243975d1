from .continuous_time import (
    ContinuousTimeGaussianDiffusion,
    LearnedLogSNR,
    LearnedScheduleDenoiser,
    VParamContinuousTimeGaussianDiffusion,
)
from .elucidated import ElucidatedDiffusion
from .gaussian import GaussianDiffusion
from .gaussian_1d import Dataset1D, GaussianDiffusion1D
from .guided import GuidedGaussianDiffusion, make_classifier_cond_fn
from .learned_variance import LearnedVarianceGaussianDiffusion
from .repaint import RePaintDiffusion
from .simple import SimpleDiffusion
from .weighted_objective import WeightedObjectiveGaussianDiffusion

__all__ = ["ContinuousTimeGaussianDiffusion", "Dataset1D",
           "ElucidatedDiffusion", "GaussianDiffusion", "GaussianDiffusion1D",
           "GuidedGaussianDiffusion", "LearnedLogSNR",
           "LearnedScheduleDenoiser", "LearnedVarianceGaussianDiffusion",
           "RePaintDiffusion", "SimpleDiffusion",
           "VParamContinuousTimeGaussianDiffusion",
           "WeightedObjectiveGaussianDiffusion", "make_classifier_cond_fn"]
