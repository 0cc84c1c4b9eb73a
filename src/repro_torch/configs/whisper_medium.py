"""whisper-medium [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

24 encoder + 24 decoder layers (whisper-medium); the mel/conv frontend is a
stub: input_specs feeds (B, 1500, d_model) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2212.04356 (Whisper)"


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        encoder_layers=24, encoder_frames=1500,
        gated_mlp=False, act="gelu", norm="ln", tie_embeddings=True,
        source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, encoder_layers=2, d_model=128,
                            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
                            encoder_frames=16)
