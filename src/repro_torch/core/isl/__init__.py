"""Inter-satellite link budget and network topology (paper §2.1 / §4.2)."""
from .link_budget import (DWDM_CHANNELS_75GHZ, DWDM_CHANNELS_100GHZ,
                          DWDM_RATE_PER_CHANNEL, PPB_OOK, PPB_PM16QAM,
                          PPB_SHANNON, OpticalTerminal,
                          required_pointing_accuracy_rad)
from .liveness import (ConstellationLinkModel, LivenessConfig,
                       choose_standby_pod)
from .topology import ISLNetwork, pod_axis_bandwidth_bytes

__all__ = [
    "OpticalTerminal", "ISLNetwork", "pod_axis_bandwidth_bytes",
    "ConstellationLinkModel", "LivenessConfig", "choose_standby_pod",
    "required_pointing_accuracy_rad", "PPB_OOK", "PPB_PM16QAM", "PPB_SHANNON",
    "DWDM_CHANNELS_100GHZ", "DWDM_CHANNELS_75GHZ", "DWDM_RATE_PER_CHANNEL",
]
