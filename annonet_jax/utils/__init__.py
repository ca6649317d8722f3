"""Cross-cutting utilities: process politeness, profiling (SURVEY.md §5)."""

from annonet_jax.utils.system import set_low_priority
from annonet_jax.utils.profiling import profiler_trace

__all__ = ["profiler_trace", "set_low_priority"]
