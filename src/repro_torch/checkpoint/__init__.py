"""Tree save/restore (``checkpointing``), npz files the JAX package reads."""
