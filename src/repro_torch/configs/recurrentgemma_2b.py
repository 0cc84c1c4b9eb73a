"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2
[arXiv:2402.19427 (Griffin)]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2402.19427 (Griffin/RecurrentGemma)"


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000, act="gelu", emb_scale=True,
        lru_width=2560, conv_width=4, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=3, d_model=120, n_heads=2, n_kv_heads=1,
                            d_ff=256, vocab=512, lru_width=120)
