"""Runtime of the port: the continuous-batching LM loop, the elastic
controller and the fault-tolerant training loop.  ``pipeline_parallel``
comes with the ROADMAP's slice G (multi-device)."""
from .elastic import ElasticController
from .serve_loop import Request, ServeLoop
from .train_loop import (
    StragglerMonitor, TrainLoopConfig, TrainState, train,
)

__all__ = ["ElasticController", "Request", "ServeLoop",
           "StragglerMonitor", "TrainLoopConfig", "TrainState", "train"]
