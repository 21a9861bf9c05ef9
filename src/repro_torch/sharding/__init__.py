"""Model-parallel storage specs of the engine (``rules``)."""
