"""Device and dtype resolution for the port.

The port runs on the card unless the caller asks for the CPU: asking for
``"cuda"`` (the default everywhere) on a machine without a usable CUDA
device raises instead of falling back. Tests pass ``"cpu"`` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(name=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` or ``"cpu"`` (or a torch.device) -> torch.device.
    Raises when CUDA is asked for and unavailable."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; ask for device('cpu') to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(np_dtype) -> torch.dtype:
    """numpy dtype (or engine DataType's ``np_dtype``) -> torch dtype."""
    return _NP_TO_TORCH[np.dtype(np_dtype)]
