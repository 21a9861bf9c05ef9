"""The paper's primary contribution: compute-group asynchrony
(``compute_groups``, ``async_sgd``: the grouped step and Theorem-1-exact
delayed SGD) with the HE/SE models (``hardware_model``, ``stat_model``,
``implicit_momentum``, ``queue_sim``) and the automatic optimizer
(``auto_optimizer``: Algorithm 1; ``bayesian``: the GP-EI baseline) over
the ``workload`` Runners, on parameter trees of nested dicts and lists
(``tree``)."""
