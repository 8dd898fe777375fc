"""Bad: boolean-mask indexing (a data-dependent output shape) inside a
device block: eager CUDA waits for the mask's count."""
import torch

LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(logits, active):
    live = active > 0
    rows = logits[live]  # LINT-EXPECT: JT007
    return torch.softmax(rows, -1)
