"""Bad: a serving-plane function reaching through the DecodeState
abstraction and addressing one family's private cache layout."""
import torch

LINT_STATE_SCOPED = True


def rows_written(cache, idx):
    kv = cache["k"]  # LINT-EXPECT: DS001
    return torch.index_select(kv, 1, idx)
