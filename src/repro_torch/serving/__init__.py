from .engine import EngineConfig, Request, ServingEngine

__all__ = ["EngineConfig", "Request", "ServingEngine"]
