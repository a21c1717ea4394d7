from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_model, lookup_model, register_model)
from .model_types import ModelType
from . import llama  # noqa: F401  (registers LLAMA3 / LLAMA3_1)
from . import qwen  # noqa: F401  (registers QWEN2 / QWEN2TIE and relatives, QWEN3)
from . import deepseek  # noqa: F401  (registers DEEPSEEK_V2_LIGHT / DEEPSEEK_V2)
from . import internvl  # noqa: F401  (registers INTERN_VL)
