"""Bad: a suppression without a justification."""
LINT_HOT_ENTRY_POINTS = ["hot_loop"]


def hot_loop(block):
    return block.cpu()  # repro-lint: allow[HS001]  # LINT-EXPECT: LN001
