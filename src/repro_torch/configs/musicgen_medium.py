"""musicgen-medium [audio]: 48L d1536 24H (MHA) d_ff=6144; decoder-only over
EnCodec tokens — 4 codebooks x 2048 vocab, delay-pattern interleave. The
EnCodec frontend is a STUB (input_specs() provides codebook token frames).
[arXiv:2306.05284]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "codebooks"   # tokens: (B, n_q, S)


def config() -> TransformerConfig:
    return TransformerConfig(
        name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
        n_kv_heads=24, d_ff=6144, vocab_size=2048, n_codebooks=4,
        pos_embed="sinusoidal", norm="layernorm", mlp_act="gelu",
        tie_embeddings=False)


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="musicgen-medium-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=64, n_codebooks=4,
        pos_embed="sinusoidal", norm="layernorm", mlp_act="gelu",
        tie_embeddings=False)
