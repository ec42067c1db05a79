"""The port's checkpointer: the reference's on-disk format."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
