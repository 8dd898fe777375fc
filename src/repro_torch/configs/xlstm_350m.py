"""xlstm-350m [ssm]: 24L d1024 4H, vocab 50304; alternating sLSTM + mLSTM
blocks, d_ff=0 (channel mixing inside blocks). [arXiv:2405.04517]"""
from repro_torch.models.xlstm import XLSTMConfig

INPUT_KIND = "tokens"


def config() -> XLSTMConfig:
    return XLSTMConfig(name="xlstm-350m", n_layers=24, d_model=1024,
                       n_heads=4, vocab_size=50304)


def reduced() -> XLSTMConfig:
    return XLSTMConfig(name="xlstm-350m-smoke", n_layers=4, d_model=64,
                       n_heads=4, vocab_size=128)
