"""Bad: .item() inside a no_host_sync body — a device read per block."""
import torch

from repro_torch.sync import no_host_sync


def decode_block(x):
    with no_host_sync(x.device):
        y = torch.softmax(x, -1)
        top = y.max().item()  # LINT-EXPECT: JT001
    return y, top
