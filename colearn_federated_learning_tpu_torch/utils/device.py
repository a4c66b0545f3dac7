"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU.
Without a GPU and without that request they raise; they never carry
on silently on the CPU.
"""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(name: str = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"device {name!r} requested but torch.cuda.is_available() "
                f"is false; pass --device cpu (device='cpu') to run on "
                f"the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev


DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
