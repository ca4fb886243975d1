from . import diffusion_math
from .guidance import apply_cfg, project
from .schedules import DiffusionSchedule, make_schedule

__all__ = ["diffusion_math", "apply_cfg", "project", "DiffusionSchedule",
           "make_schedule"]
