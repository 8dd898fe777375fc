"""Bad: a draw from torch's global generator in a replay-sensitive
module: not a function of a replay id, so chaos replay diverges."""
import torch

LINT_REPLAY_SENSITIVE = True


def strike_noise(n):
    return torch.rand(n)  # LINT-EXPECT: PR001
