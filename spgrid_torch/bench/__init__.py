"""Benchmark harness of the port and its headline."""
