"""internvl2-2b [vlm] — InternViT (stub) + InternLM2 LM [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2404.16821 (InternVL 1.5/2 report)"


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92553, n_patches=256, rope_theta=1e6,
        tie_embeddings=False, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=128, n_heads=4,
                            n_kv_heads=2, d_ff=256, vocab=512, n_patches=8)
