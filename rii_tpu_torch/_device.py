"""Device resolution shared by the codec and the engine.

The device is given by the caller (the entry points default to
``"cuda"``) and is never detected. Asking for CUDA where no card is visible
raises; nothing falls back to the CPU.
"""

import torch


def resolve_device(device):
    """Validate ``device`` and return it as a ``torch.device``.

    A CUDA device without an index gets the index of the calling thread's
    current card, so that the codec and the engine name one card whichever
    thread later queries them. For CUDA this also pins float32 matrix
    products to full float32 (no TF32), the counterpart of the JAX package's
    ``Precision.HIGHEST``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cpu' or 'cuda')")
    return dev
