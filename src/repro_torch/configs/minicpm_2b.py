"""minicpm-2b [dense]: 40L d2304 36H (MHA) d_ff=5760, vocab 122753;
WSD schedule; mu-P-style embed/residual/logit scaling. [arXiv:2404.06395]"""
from repro_torch.models.transformer import TransformerConfig

INPUT_KIND = "tokens"
LR_SCHEDULE = "wsd"   # warmup-stable-decay (the paper's training schedule)


def config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36,
        n_kv_heads=36, d_ff=5760, vocab_size=122880, tie_embeddings=True,  # vocab 122753 padded to 256-multiple
        embed_scale=12.0, residual_scale=1.4 / 40 ** 0.5,
        logit_scale=256.0 / 2304.0, mlp_act="swiglu")


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b-smoke", n_layers=2, d_model=72, n_heads=6,
        n_kv_heads=6, d_ff=160, vocab_size=128, tie_embeddings=True,
        embed_scale=12.0, residual_scale=1.4 / 2 ** 0.5,
        logit_scale=256.0 / 72.0, mlp_act="swiglu")
