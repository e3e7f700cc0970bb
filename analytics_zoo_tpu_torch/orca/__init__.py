from ..common.config import OrcaConfig, OrcaContext
from ..common.context import init_orca_context, stop_orca_context

__all__ = ["OrcaConfig", "OrcaContext", "init_orca_context",
           "stop_orca_context"]
