"""Bad: the same Threefry key consumed twice."""
from repro_torch.serving import prng

LINT_REPLAY_SENSITIVE = True


def sample_two(seed, tick, logits):
    key = prng.fold_in(prng.PRNGKey(seed), tick)
    a = prng.categorical(key, logits)
    b = prng.categorical(key, logits)  # LINT-EXPECT: PR002
    return a, b
