from .profiling import (NFECounter, Timer, clear_spans, set_spans, span,
                        span_record, trace)

__all__ = ["NFECounter", "Timer", "clear_spans", "set_spans", "span",
           "span_record", "trace"]
