"""Model library: the transformer core and the architecture wrappers (the
counterpart of ``megatron_llm_tpu/models``; Mixtral waits for the mixture
of experts, BERT and T5 for their own entry points)."""

from megatron_llm_torch.models.falcon import FalconModel, falcon_config
from megatron_llm_torch.models.gemma import GemmaModel, gemma_config
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.models.gpt2 import gpt2_config
from megatron_llm_torch.models.gpt_neox import GPTNeoXModel, gpt_neox_config
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.models.mistral import MistralModel, mistral_config
from megatron_llm_torch.models.qwen2 import Qwen2Model, qwen2_config

MODEL_REGISTRY = {
    "gpt": GPTModel,
    "llama": LlamaModel,
    "llama2": LlamaModel,
    "llama3": LlamaModel,
    "codellama": LlamaModel,
    "falcon": FalconModel,
    "mistral": MistralModel,
    "qwen2": Qwen2Model,
    "gemma": GemmaModel,
    "gpt_neox": GPTNeoXModel,
    "pythia": GPTNeoXModel,
}
