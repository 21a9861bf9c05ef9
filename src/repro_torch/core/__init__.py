"""Compute groups and the grouped asynchronous SGD step (``compute_groups``,
``async_sgd``), over parameter trees of nested dicts and lists (``tree``)."""
