"""Share of the profiled stretch of serving (%) in which no operation ran
on the device: 1 - busy / window from the device trace."""
from harness.readers import idle_share as read  # noqa: F401
