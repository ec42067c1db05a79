"""Serving runtime of the port: the continuous-batching LM loop and the
elastic controller.  Training (``train_loop``, ``pipeline_parallel``)
comes with the ROADMAP's slice F3."""
from .elastic import ElasticController
from .serve_loop import Request, ServeLoop

__all__ = ["ElasticController", "Request", "ServeLoop"]
