"""Optimizers: paper-eq-(3)/(4) momentum SGD (``sgd``) and the closed form
of g stale sub-steps (``closed_form``, numpy float64)."""
