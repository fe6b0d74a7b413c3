"""Host utilities of the port: timing, tracing and the pipeline's spans
(``profiling``), HTML reports (``report``)."""

from doa_tpu_torch.utils.profiling import Timer, span, trace_to

__all__ = ["Timer", "span", "trace_to"]
