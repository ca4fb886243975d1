from .metrics_log import MetricsLogger

__all__ = ["MetricsLogger"]
