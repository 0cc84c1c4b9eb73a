"""Dispatch to the hand-written kernels by the device of the input.

A CUDA tensor goes to the kernel, which raises if it cannot be built or
launched; a CPU tensor goes to the kernel's plain torch version.  There is
no fallback from one to the other.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 1024, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,KH,hd) -> (B,Sq,H,hd).

    ``block_q``/``block_k`` tile the plain version only; the kernel uses its
    own tiles.  ``q_offset`` (q[0]'s position) is taken on the CPU only: the
    serving slice never asks the kernel for it.
    """
    if q.device.type == "cuda":
        if q_offset:
            raise NotImplementedError(
                "flash_attention kernel: q_offset != 0 is not supported")
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         block_q=block_q, block_k=block_k,
                                         q_offset=q_offset)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
