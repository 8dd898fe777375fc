"""Bad: int() of a device tensor per value in a host hot loop."""
import torch

LINT_HOT_ENTRY_POINTS = ["hot_loop"]


def hot_loop(xs):
    total = 0
    for x in xs:
        n = torch.count_nonzero(x)
        total += int(n)  # LINT-EXPECT: HS003
    return total
