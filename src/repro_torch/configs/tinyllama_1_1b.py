"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2401.02385 (TinyLlama)"


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000, tie_embeddings=False, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=128, n_heads=4,
                            n_kv_heads=2, d_ff=256, vocab=512)
