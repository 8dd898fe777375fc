"""Bad: waiting for the device inside a host hot loop (not a measurement)."""
import torch

LINT_HOT_ENTRY_POINTS = ["hot_loop"]


def hot_loop(xs):
    for _ in xs:
        torch.cuda.synchronize()  # LINT-EXPECT: HS002
    return xs
