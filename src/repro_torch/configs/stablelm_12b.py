"""stablelm-12b [dense]: 40L d5120 32H (GQA kv=8) d_ff=13824, vocab 100352.
[hf:stabilityai/stablelm-2-12b]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=13824, vocab_size=100352, tie_embeddings=False,
        norm="layernorm", mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-12b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=128, tie_embeddings=False,
        norm="layernorm", mlp_act="swiglu")
