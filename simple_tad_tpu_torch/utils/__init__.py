"""Normalization folding and checkpoint conversion."""
