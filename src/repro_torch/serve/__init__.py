"""Continuous-batching serving over the slot-decode model path."""
from .engine import ServeEngine
from .request import Completion, Request, RequestQueue
from .slots import SlotAllocator

__all__ = ["Request", "Completion", "RequestQueue", "SlotAllocator", "ServeEngine"]
