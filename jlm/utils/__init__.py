"""Observability utilities (SURVEY.md §7: tracing/metrics/logging)."""

from jlm.utils.logging import JsonlLogger, timed_span  # noqa: F401
from jlm.utils.profiling import device_timer, trace  # noqa: F401
