from .profiling import NFECounter, Timer, trace

__all__ = ["NFECounter", "Timer", "trace"]
