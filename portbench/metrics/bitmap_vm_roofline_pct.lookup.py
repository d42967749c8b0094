"""Kernel ``bitmap_vm``: the launches' least time (bytes at the HBM peak or
word operations at the 32-bit peak, whichever is larger) over their device
time in the trace, in percent."""
from portbench.harness import arith

LAUNCHES = {"repro_torch.kernels.bitmap:bitmap_vm": arith.bitmap_vm_cost}
KERNEL = r"bitmap_vm_kernel"


def read(obs):
    return obs.roofline_pct(LAUNCHES, KERNEL)
