"""transformer_wmt — the paper's own model: standard Transformer (Vaswani),
used for the WMT17 convergence experiments (paper §V-C). Encoder consumes
source tokens (no modality stub).  The init holds 79,724,544 params: 6
encoder and 6 decoder layers (44,070,912), two 32768 x 512 embeddings
(``emb``, tied to the unembed, and ``src_emb``; 33,554,432), the learned
``enc_pos`` (4096 x 512; 2,097,152) and the final norms (2,048)."""
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
