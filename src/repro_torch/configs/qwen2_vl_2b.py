"""qwen2-vl-2b [vlm]: 28L d1536 12H (GQA kv=2) d_ff=8960, vocab 151936;
M-RoPE (t/h/w sections), dynamic resolution. The vision tower is a STUB:
input_specs() provides precomputed patch embeddings / 3D position ids.
[arXiv:2409.12191]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "vlm"   # tokens + (3, B, S) M-RoPE position ids


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-vl-2b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab_size=151936, tie_embeddings=True,
        qkv_bias=True, mrope_sections=(16, 24, 24), mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-vl-2b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=192, vocab_size=128, tie_embeddings=True,
        qkv_bias=True, mrope_sections=(4, 2, 2), mlp_act="swiglu")
