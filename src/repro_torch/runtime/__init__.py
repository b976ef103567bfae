"""Runtime fault tolerance: heartbeat, straggler watchdog, elastic restart."""
from .fault import (ElasticController, FaultInjector, Heartbeat,
                    StepWatchdog, run_with_retries)
__all__ = ["ElasticController", "FaultInjector", "Heartbeat",
           "StepWatchdog", "run_with_retries"]
