"""Bad: np.asarray of a tensor inside a device block pulls it to the host."""
import numpy as np

LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(x):
    return np.asarray(x)  # LINT-EXPECT: JT003
