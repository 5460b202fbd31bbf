"""Workload pipelines."""
