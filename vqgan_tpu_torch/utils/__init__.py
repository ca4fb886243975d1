from .metrics_log import MetricsLogger
from .profiling import StepTimer, annotate, trace

__all__ = ["MetricsLogger", "StepTimer", "annotate", "trace"]
