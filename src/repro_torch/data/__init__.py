"""Deterministic, shardable, resumable synthetic token pipeline."""
from .pipeline import TokenPipeline, DataState  # noqa: F401
