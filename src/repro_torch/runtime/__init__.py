"""Runtime of the port: the continuous-batching LM loop, the elastic
controller, the fault-tolerant training loop and GPipe pipeline
parallelism over a mesh's ``stage`` axis."""
from .elastic import ElasticController
from .pipeline_parallel import pipeline_apply
from .serve_loop import Request, ServeLoop
from .train_loop import (
    StragglerMonitor, TrainLoopConfig, TrainState, train,
)

__all__ = ["ElasticController", "pipeline_apply", "Request", "ServeLoop",
           "StragglerMonitor", "TrainLoopConfig", "TrainState", "train"]
