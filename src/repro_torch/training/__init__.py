from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.checkpoint import (load_checkpoint, restore_like,
                                             save_checkpoint)
from repro_torch.training.data import SyntheticLMData
