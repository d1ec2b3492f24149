"""Paged serving engine of the port: engine, request/slot types, KV pool
and sampler."""

from .engine import ServingEngine
from .scheduler import (EngineDraining, EngineOverloaded, Request,
                        ServingConfig)

__all__ = ["EngineDraining", "EngineOverloaded", "Request", "ServingConfig",
           "ServingEngine"]
