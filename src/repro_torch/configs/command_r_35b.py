"""command-r-35b [dense]: 40L d8192 64H (GQA kv=8) d_ff=22528, vocab 256000;
parallel attention+FFN block, no biases, logit_scale 0.0625.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"


def config() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22528, vocab_size=256000, tie_embeddings=True,
        parallel_block=True, norm="layernorm", logit_scale=0.0625,
        mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-35b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=128, tie_embeddings=True,
        parallel_block=True, norm="layernorm", logit_scale=0.0625,
        mlp_act="swiglu")
