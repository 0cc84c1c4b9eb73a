"""Config dataclasses for the model zoo and the distributed run."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # window of "local" attention layers
    local_per_global: int = 0               # gemma3: 5 local then 1 global
    causal: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                      # llama4: MoE every other layer
    first_dense: int = 0                    # kimi: leading dense layers
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_chunks: int = 8                     # token-chunked dispatch (memory)
    moe_impl: str = "shardmap"              # shardmap | slotmap | onehot_scatter
    router_aux_coef: float = 0.01

    # SSM / hybrid
    block_pattern: Tuple[str, ...] = ()     # e.g. ("rglru","rglru","attn")
    conv_width: int = 4                     # RG-LRU temporal conv
    lru_width: Optional[int] = None

    # enc-dec / modality frontends (STUBS per assignment)
    encoder_layers: int = 0
    encoder_frames: int = 0                 # whisper: 1500 frame embeddings
    n_patches: int = 0                      # internvl2: 256 patch embeddings

    # misc
    act: str = "silu"
    gated_mlp: bool = True                  # SwiGLU vs plain MLP
    norm: str = "rms"                       # rms | ln
    emb_scale: bool = False                 # gemma: scale emb by sqrt(d)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    attn_block_q: int = 512                 # blocked-attention tile sizes
    attn_block_k: int = 1024
    mlstm_chunk: int = 256
    source: str = ""                        # paper/model-card citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to /256 so it shards evenly over the
        model axis (whisper 51865, internvl2 92553 are not %16)."""
        return ((self.vocab + 255) // 256) * 256

    def variant(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        """Explicit `swa` variant for long_500k on full-attention archs.

        sliding_window set with local_per_global == 0 means *all* attention
        layers are windowed (uniform-local); local_per_global = k > 0 means
        the gemma3-style k-local-then-1-global pattern.
        """
        return replace(self, sliding_window=window,
                       name=self.name + "+swa")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    arch: str = "tinyllama-1.1b"
    shape: str = "train_4k"
    averager: str = "wagma"                 # wagma | allreduce | local_sgd | ...
    group_size: Optional[int] = None        # None -> sqrt(P)
    tau: int = 10
    multi_pod: bool = False
    optimizer: str = "sgd"                  # paper's optimiser
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    steps: int = 100
    seed: int = 0
    microbatch: Optional[int] = None        # grad-accumulation chunks
    remat: bool = True
    fsdp: int = 1                           # hierarchical WAGMA: FSDP factor
