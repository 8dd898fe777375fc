from .ops import rglru_scan
from .ref import rglru_scan_backward_reference, rglru_scan_reference

__all__ = ["rglru_scan", "rglru_scan_backward_reference",
           "rglru_scan_reference"]
