"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2405.04517 (xLSTM)"


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=128, n_heads=2,
                            n_kv_heads=2, vocab=512)
