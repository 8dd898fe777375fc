"""The paper's end-to-end demo model: a ~100M-param dense GQA LM."""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="suncatcher-lm-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=32768, tie_embeddings=True,
        mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="suncatcher-lm-100m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, tie_embeddings=True,
        mlp_act="swiglu")
