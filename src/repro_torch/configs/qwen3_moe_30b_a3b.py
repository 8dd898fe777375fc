"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) d_ff=768/expert,
vocab 151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=768, vocab_size=151936, num_experts=128, top_k=8,
        tie_embeddings=False, mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-30b-a3b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=32, vocab_size=256, num_experts=8, top_k=2,
        tie_embeddings=False, mlp_act="swiglu")
