from ggnn_torch.utils.logging import get_log_level, set_log_level, vlog
from ggnn_torch.utils.timing import PhaseTimer

__all__ = ["get_log_level", "set_log_level", "vlog", "PhaseTimer"]
