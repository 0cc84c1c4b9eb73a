"""gemma3-12b [dense] — 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt family card]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "hf:google/gemma-3-1b-pt (Gemma 3 family)"


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_ff=15360, vocab=262144,
        sliding_window=1024, local_per_global=5, qk_norm=True,
        emb_scale=True, act="gelu", rope_theta=1e6, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
                            d_ff=256, vocab=512, sliding_window=32,
                            local_per_global=2)
