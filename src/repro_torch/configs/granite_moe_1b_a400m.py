"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) d_ff=512/expert,
vocab 49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab_size=49408, num_experts=32, top_k=8,
        tie_embeddings=True, mlp_act="swiglu")   # vocab 49155 padded to 256


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab_size=128, num_experts=4, top_k=2,
        tie_embeddings=True, mlp_act="swiglu")
