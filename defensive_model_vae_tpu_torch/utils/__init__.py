from .profiling import StageTimer, trace_to
from .reporting import MetricWriter, band_stats, jsonable

__all__ = ["StageTimer", "trace_to", "MetricWriter", "band_stats", "jsonable"]
