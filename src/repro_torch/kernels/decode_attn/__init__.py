"""GQA flash-decode attention kernel (CUDA); see ``csrc/decode_attn.cu``."""

from .ops import decode_attention, decode_attention_cost  # noqa: F401
