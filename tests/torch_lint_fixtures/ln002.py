"""Bad: a justified suppression that baseline.txt does not mirror."""
LINT_HOT_ENTRY_POINTS = ["hot_loop"]


def hot_loop(block):
    return block.cpu()  # repro-lint: allow[HS001] the one drain  # LINT-EXPECT: LN002
