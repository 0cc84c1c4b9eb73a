"""llama4-maverick-400b-a17b [moe] — 128e top-1 + shared expert, MoE every
other layer [hf:meta-llama/Llama-4-Scout-17B-16E family card]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "hf:meta-llama/Llama-4-Scout-17B-16E (Llama 4 family)"


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048,
        n_experts=128, top_k=1, moe_every=2, shared_expert=True,
        tie_embeddings=False, rope_theta=5e5, source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                            d_ff=256, vocab=512, n_experts=4, moe_chunks=2)
