from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS,
                                      ModelConfig, ShapeConfig, get_config,
                                      reduced_config)

#: every config this package carries: the reference's assigned architectures
#: and the paper's evaluation models
PORTED_ARCH_IDS = tuple(ARCH_IDS + PAPER_ARCH_IDS)
