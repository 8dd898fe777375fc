"""Bad: a Python branch on a tensor value inside a device block."""
import torch

LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(x, done):
    if done.any():  # LINT-EXPECT: JT006
        x = torch.zeros_like(x)
    return x
