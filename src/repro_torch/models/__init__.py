"""Model zoo (port of `repro.models`): the architecture configuration of
all ten assigned models, the shared layers and the training loss, GQA
attention with the `decode_attn` kernel on every decode step
(cross-attention included), the RG-LRU block, the mixture-of-experts
layer, multi-head latent attention, the Mamba-2 SSD block, and `Model`
for the dense (qwen3, granite, nemotron), MoE (dbrx, deepseek-v3), SSM
(mamba2), hybrid (recurrentgemma), encoder-decoder (whisper) and VLM
(internvl2) families."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
