"""Bad: a per-item device-to-host copy in a host hot loop."""
LINT_HOT_ENTRY_POINTS = ["hot_loop"]


def hot_loop(xs):
    out = []
    for x in xs:
        out.append(x.cpu())  # LINT-EXPECT: HS001
    return out
