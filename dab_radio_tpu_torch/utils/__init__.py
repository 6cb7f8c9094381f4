"""Shared utilities: device selection and the tracing profiler."""

from .profiler import Profiler, profile_scope, get_profiler
