"""Architecture configs: the 10 assigned archs + the paper's own Transformer.

Each ``<id>.py`` exposes ``config()`` (exact assigned dimensions) and
``smoke_config()`` (reduced: <=2 blocks, d_model<=512, <=4 experts) for CPU
smoke tests. ``get_config(name)`` resolves by arch id.
"""

from repro_torch.configs.base import ModelConfig, RunConfig, SHAPES, InputShape

_ARCHS = (
    "xlstm_350m", "qwen3_0_6b", "whisper_medium", "starcoder2_7b",
    "internvl2_2b", "gemma3_12b", "llama4_maverick_400b_a17b",
    "kimi_k2_1t_a32b", "tinyllama_1_1b", "recurrentgemma_2b",
    "transformer_wmt",
)

_ALIASES = {
    "xlstm-350m": "xlstm_350m",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-medium": "whisper_medium",
    "starcoder2-7b": "starcoder2_7b",
    "internvl2-2b": "internvl2_2b",
    "gemma3-12b": "gemma3_12b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "transformer-wmt": "transformer_wmt",
}


def arch_names():
    return list(_ALIASES)[:-1]  # the 10 assigned ids (dashed form)


def _module(name: str):
    import importlib
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _module(name)
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ModelConfig", "RunConfig", "SHAPES", "InputShape",
           "get_config", "arch_names"]
