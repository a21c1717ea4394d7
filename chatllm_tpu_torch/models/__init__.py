from .base import (BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig,
                   load_model, lookup_model, register_model)
from .model_types import ModelType
from . import llama  # noqa: F401  (registers LLAMA2, CODELLAMA, LLAMA3 / 3_1 / 3_2, R1 distill)
from . import mistral  # noqa: F401  (registers MISTRAL, MIXTRAL / WIZARDLM2_MOE, MISTRAL2)
from . import qwen  # noqa: F401  (registers QWEN2 and relatives, QWEN2MoE, QWEN3, R1 distills)
from . import deepseek  # noqa: F401  (registers DeepSeek V1, V1-MoE, V2, V3)
from . import internvl  # noqa: F401  (registers INTERN_VL)
from . import gemma  # noqa: F401  (registers GEMMA, GEMMA2, GEMMA3)
from . import misc_wave2  # noqa: F401  (registers RNJ_1)
from . import glm  # noqa: F401  (registers CHATGLM2 / 3, CODEGEEX2 / 4, GLM4, GLM4_0414, CHARACTERGLM)
from . import phi  # noqa: F401  (registers the PHI2 / 3 / 4 types but PHI3_MOE)
from . import gpt_oss  # noqa: F401  (registers GPT_OSS)
