"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384e top-8 + shared expert,
first layer dense (paper-table giant) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

SOURCE = "arXiv:2501.kimi2 (Kimi K2)"


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, moe_every=1, first_dense=1,
        shared_expert=True, tie_embeddings=False, rope_theta=5e6,
        source=SOURCE,
    )


def smoke_config() -> ModelConfig:
    return config().variant(n_layers=3, first_dense=1, d_model=128,
                            n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
                            n_experts=4, top_k=2, moe_chunks=2)
