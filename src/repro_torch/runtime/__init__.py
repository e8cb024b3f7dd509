"""Runtime: fault tolerance (heartbeat, straggler flags, the
checkpoint/restart training loop)."""
from .fault import FaultTolerantLoop, Heartbeat, LoopResult, StragglerMonitor

__all__ = ["Heartbeat", "StragglerMonitor", "FaultTolerantLoop", "LoopResult"]
