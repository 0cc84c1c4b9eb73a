"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2402.19173 (StarCoder2)"


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab=49152,
        gated_mlp=False, act="gelu", norm="ln", rope_theta=1e5,
        tie_embeddings=False, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=144, n_heads=4,
                            n_kv_heads=2, d_ff=512, vocab=512)
