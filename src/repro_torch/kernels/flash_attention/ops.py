"""Flash-attention wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

from ..common import count_launch, on_cpu
from .kernel import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, scale=None, causal: bool = False,
                    window: int = 0, softcap: float = 0.0,
                    bq: int = 128, bk: int = 128, layout: str = "HLD",
                    pin=None):
    """Multi-head attention through the flash kernel.

    ``layout="HLD"``: q is (B, Hq, Lq, D), k/v are (B, Hkv, Lk, D) ->
    (B, Hq, Lq, D).  ``layout="LHD"``: all sequence-major (B, L, H, D),
    read and written where they lie.  GQA needs Hq % Hkv == 0; Lq, Lk and
    the head dim may have any length.  f32, bf16 or f16, computed in f32,
    returned in q's dtype.  ``bq``/``bk`` are the reference's tile sizes,
    kept in the signature: the CUDA kernel's tiles come from its launch
    planner and it masks ragged tiles, so neither changes the result.
    ``pin = (bq, splits)`` launches that query tile and KV split instead
    of the planner's (a tuned variant's); the plain version ignores it.
    """
    assert layout in ("HLD", "LHD")
    if bq < 1 or bk < 1:
        raise ValueError(f"tile sizes {bq}, {bk}")
    d = q.shape[-1]
    kw = dict(scale=float(scale if scale is not None else d ** -0.5),
              causal=causal, window=window, softcap=softcap,
              seq_major=layout == "LHD")
    if on_cpu(q):
        return flash_attention_ref(q, k, v, **kw)
    out = flash_attention_cuda(q, k, v, pin=pin, **kw)
    count_launch("flash_attention")
    return out
