"""Benchmark drivers of the port."""
