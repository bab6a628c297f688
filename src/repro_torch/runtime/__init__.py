"""The training runtime's host-side policy (the JAX package's
``repro.runtime`` without its mesh code, ``elastic.py``)."""
from .fault_tolerance import (FaultInjector, Heartbeat, RunReport,
                              StragglerDetector, TrainController)

__all__ = ["FaultInjector", "Heartbeat", "RunReport", "StragglerDetector",
           "TrainController"]
