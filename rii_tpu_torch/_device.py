"""Device resolution shared by the codec and the engine.

The device is always given by the caller (default ``"cpu"``) and is never
detected. Asking for CUDA where no card is visible raises; nothing falls
back to the CPU.
"""

import torch


def resolve_device(device):
    """Validate ``device`` and return it as a ``torch.device``.

    For CUDA this also pins float32 matrix products to full float32 (no
    TF32), the counterpart of the JAX package's ``Precision.HIGHEST``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cpu' or 'cuda')")
    return dev
