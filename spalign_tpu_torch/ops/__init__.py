"""Tensor ops of the label path: segments, align, prior, k-means."""
