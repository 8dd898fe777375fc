"""Bad: an f-string of a tensor inside a device block reads it."""
LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]


def step(x, log):
    log.append(f"loss {x}")  # LINT-EXPECT: RT003
    return x
