"""transformer_wmt — the paper's own model: standard Transformer (Vaswani),
61,362,176 trainable params, used for the WMT17 convergence experiments
(paper §V-C). Encoder consumes source tokens (no modality stub)."""
from repro_torch.configs.base import ModelConfig

SOURCE = "paper §V-C / arXiv:1706.03762 (Transformer base)"


def config() -> ModelConfig:
    return ModelConfig(
        name="transformer-wmt", family="audio",   # encdec path, token encoder
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=32768,
        encoder_layers=6, encoder_frames=0,       # 0 -> token encoder (src)
        gated_mlp=False, act="relu", norm="ln", source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, encoder_layers=2, d_model=128,
                            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512)
