"""Synthetic data streams and prefetch (``pipeline``)."""
