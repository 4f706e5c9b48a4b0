"""Kernels' operation and byte counts, from the shapes each launch gets."""
