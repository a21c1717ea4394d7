from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_model, lookup_model, register_model)
from .model_types import ModelType
from . import llama  # noqa: F401  (registers LLAMA3 / LLAMA3_1 / LLAMA3_2, the R1 distill)
from . import qwen  # noqa: F401  (registers QWEN2 and relatives, QWEN2MoE, QWEN3, R1 distills)
from . import deepseek  # noqa: F401  (registers DeepSeek V1, V1-MoE, V2, V3)
from . import internvl  # noqa: F401  (registers INTERN_VL)
