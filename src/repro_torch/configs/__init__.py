from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS,
                                      ModelConfig, ShapeConfig, get_config,
                                      reduced_config)

#: configs this package carries (the dense models of the serving slice)
PORTED_ARCH_IDS = ("mistral_7b", "qwen2_7b", "llama3_8b")
