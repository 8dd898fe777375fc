"""Batched serving: the continuous-batching engine, and the serving plane
of liveness-routed, warm-standby-replicated engine replicas (router.py)
with declarative fault injection (chaos.py)."""
from .chaos import (ChaosEvent, ChaosSchedule, as_chaos_schedule,
                    parse_outage_spec)
from .engine import EngineConfig, Request, ServingEngine
from .router import (ConstellationRouter, ForcedOutage, GridConfig,
                     check_forced_outage_contract, liveness_mask_fn)

__all__ = ["ChaosEvent", "ChaosSchedule", "ConstellationRouter",
           "EngineConfig", "ForcedOutage", "GridConfig", "Request",
           "ServingEngine", "as_chaos_schedule",
           "check_forced_outage_contract", "liveness_mask_fn",
           "parse_outage_spec"]
