"""Host utilities of the port: timing and tracing (``profiling``),
streaming metrics (``metrics``), HTML reports (``report``)."""

from doa_tpu_torch.utils.profiling import Timer, trace_to, throughput_report
from doa_tpu_torch.utils.metrics import PipelineMetrics

__all__ = ["Timer", "trace_to", "throughput_report", "PipelineMetrics"]
