"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "hf:Qwen/Qwen3-8B (Qwen3 family card)"


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6,
        source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=256, n_heads=4,
                            n_kv_heads=2, d_ff=512, vocab=512)
