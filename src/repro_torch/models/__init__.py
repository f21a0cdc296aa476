from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params)
