"""Kernel ``xor_delta``: the launches' least time (bytes at the HBM peak or
word operations at the 32-bit peak, whichever is larger) over their device
time in the trace, in percent.  The read path launches it only through the
ragged entry (``ops.xor_delta_pairs``); its device code is
``rowwise.cuh``'s kernels with ``kAnd = false``.  Were the (N, W) entry
launched too, the kernel count would exceed the counted launches and the
share would read nothing."""
from portbench.harness import arith

LAUNCHES = {
    "repro_torch.kernels.deltaenc:xor_delta_ragged": arith.xor_delta_ragged_cost}
KERNEL = r"(narrow|split)_kernel<false"


def read(obs):
    return obs.roofline_pct(LAUNCHES, KERNEL)
