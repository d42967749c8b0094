"""PyTorch/CUDA port of the RStore reproduction.

Imports ``torch`` and numpy only — never JAX and nothing of the reference
package ``repro``.  Entry points that touch a device run on the card unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
