"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) d_ff=7680,
vocab 256000; RG-LRU + local attention (window 2048), 1:2 pattern.
[arXiv:2402.19427]"""
from repro_torch.models.rglru import RGLRUConfig

INPUT_KIND = "tokens"


def config() -> RGLRUConfig:
    return RGLRUConfig(name="recurrentgemma-2b", n_layers=26, d_model=2560,
                       n_heads=10, n_kv_heads=1, d_ff=7680,
                       vocab_size=256000, window=2048)


def reduced() -> RGLRUConfig:
    return RGLRUConfig(name="recurrentgemma-2b-smoke", n_layers=5,
                       d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
                       vocab_size=128, window=16, conv_width=4)
