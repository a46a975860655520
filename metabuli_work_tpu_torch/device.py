"""Device choice for the package's entry points.

Entry points (Classifier, the CLI, chip_smoke.py) run on the CUDA card
unless the caller asks for the CPU explicitly; the CPU path exists for
the tests and for equality checks against the card.  A missing card is
an error, never a silent switch to the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """None or "cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
