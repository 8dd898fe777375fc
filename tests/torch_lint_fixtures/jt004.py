"""Bad: .cpu() inside a device block reached from a no_host_sync body."""
import torch

from repro_torch.sync import no_host_sync


def _metrics(loss):
    return loss.cpu()  # LINT-EXPECT: JT004


def fused(loss):
    with no_host_sync(loss.device):
        m = _metrics(torch.stack([loss, loss]))
    return m
