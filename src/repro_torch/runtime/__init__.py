"""Runtime: the serving half of fault tolerance (heartbeat, straggler flags)."""
from .fault import Heartbeat, StragglerMonitor

__all__ = ["Heartbeat", "StragglerMonitor"]
