from repro_torch.utils.bytesize import human_bytes, parse_bytes
from repro_torch.utils.timing import Timer, SimClock
from repro_torch.utils.logging import get_logger

__all__ = ["human_bytes", "parse_bytes", "Timer", "SimClock", "get_logger"]
