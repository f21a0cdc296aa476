"""Hardware constants of the card the port runs on, in the cost model's
`HardwareSpec` form, so the port's scheduler never reasons with TPU numbers.

Datasheet values for one H100 SXM (NVIDIA data sheet): 989e12 dense bf16
FLOP/s, 3.35e12 B/s HBM3, NVLink 900 GB/s all-to-all = 450e9 B/s each way.
`mfu` starts at the value the reference gives its A100 spec until
`EngineBackend.calibrate_costmodel` measures it on the card.
"""
import torch

from repro_torch.sp.planner import HardwareSpec

H100_SXM = HardwareSpec(name="h100_sxm", flops=989e12, hbm_bw=3.35e12,
                        link_bw=450e9, inter_bw=450e9, bytes_per_elt=2,
                        mfu=0.5)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (the default) but absent — an
    entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev
