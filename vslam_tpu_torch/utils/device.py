"""Where the port runs: on the card, unless the caller asks for the CPU.

Every constructor and public function of the port that builds state
takes `device=DEFAULT_DEVICE` and passes it through `resolve_device`,
which raises when CUDA is asked for and there is no card: nothing falls
back to the CPU.  CPU users pass device="cpu".
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The torch device to run on; a CUDA device without a card raises
    RuntimeError, and a bare "cuda" becomes the current card's index."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                               "available (pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
