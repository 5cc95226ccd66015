"""roomnet_tpu_torch — the RoomNet classifier in PyTorch, for an NVIDIA H100.

A port of `roomnet_tpu` (JAX/XLA/Pallas): the same model, the same flat
`.npz` parameters and the same NHWC/HWIO layouts at every public function,
with each of the JAX package's four Pallas kernels rewritten by hand in
CUDA C++ for Hopper (`csrc/`, built with nvcc at first use). On a CPU tensor
every kernel wrapper runs its plain PyTorch version instead, which is what
the CPU tests compare against the JAX package.

Entry points run on `cuda` unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise.
"""

from __future__ import annotations

__version__ = "0.1.0"

CLASS_LABELS = ["Backyard", "Bathroom", "Bedroom", "Frontyard", "Kitchen", "LivingRoom"]


def default_device(device=None):
    """The device an entry point runs on: the caller's, else `cuda`.

    Raises RuntimeError when no device is given and CUDA is unavailable —
    there is no silent fallback to the CPU.
    """
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "roomnet_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")
