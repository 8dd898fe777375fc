"""Bad: a device wait inside a device block."""
import torch

LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(x):
    y = x * 2
    torch.cuda.synchronize()  # LINT-EXPECT: JT005
    return y
