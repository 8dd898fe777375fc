"""Bad: float() of a tensor inside a device block."""
import torch

LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(x):
    scale = float(torch.amax(x))  # LINT-EXPECT: JT002
    return x / scale
