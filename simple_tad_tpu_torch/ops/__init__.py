"""Kernels with their plain versions, attention dispatch and image ops."""
