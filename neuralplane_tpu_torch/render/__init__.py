from .acmi import ACMIWriter
from .trajectory import TrajectoryRecorder, evaluate_metrics, model_channels, plot_result

__all__ = ["ACMIWriter", "TrajectoryRecorder", "evaluate_metrics", "model_channels",
           "plot_result"]
