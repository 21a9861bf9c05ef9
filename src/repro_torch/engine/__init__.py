"""The training engine (``engine.Engine``, strategies in ``strategies``)
and timing: the port's one clock, its CUDA-synchronizing probe and the
per-step ``Telemetry``."""
from repro_torch.engine.engine import Engine
