"""qwen2.5-32b [dense]: 64L d5120 40H (GQA kv=8) d_ff=27648, vocab 152064;
QKV bias. [hf:Qwen/Qwen2.5-32B]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=27648, vocab_size=152064, tie_embeddings=False,
        qkv_bias=True, mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b-smoke", n_layers=2, d_model=80, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=128, tie_embeddings=False,
        qkv_bias=True, mlp_act="swiglu")
