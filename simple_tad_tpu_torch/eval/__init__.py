"""Sliding-window evaluation engine and metrics."""
