"""Diagnostic scripts for the port's kernels (they need the GPU)."""
