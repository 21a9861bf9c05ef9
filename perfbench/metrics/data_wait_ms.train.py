"""Mean host wait for the next batch a round (ms): the program's
``engine.data_wait`` spans over the window's unprofiled rounds. It holds
the pin and copy of the batch that ``data/pipeline.prefetch`` makes on the
loop's own thread."""
from harness.readers import data_wait_ms as read  # noqa: F401
