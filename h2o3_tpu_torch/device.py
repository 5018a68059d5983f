"""Device resolution for the PyTorch port.

Entry points run on ``cuda``. The CPU is used only when the caller asks for
it: per call (``device="cpu"``) or for the whole process through
`set_device`, which the parity tests do. A request for ``cuda`` on a host
without a usable GPU raises; nothing falls back to the CPU silently.

On a rank of a multi-process cloud (`parallel.mesh.init`) ``cuda`` means
the rank's own card, which the cloud selected at init.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_default: Optional[torch.device] = None
# this rank's card on a multi-process cloud (`parallel.mesh.init` sets it)
_rank_card: Optional[torch.device] = None


def set_device(device: DeviceLike) -> None:
    """Set the process default device (``None`` restores ``cuda``)."""
    global _default
    _default = torch.device(device) if device is not None else None


def default_device() -> Optional[torch.device]:
    """The device `set_device` chose, or None."""
    return _default


def rank_device() -> Optional[torch.device]:
    """This rank's card on a multi-process cloud, or None."""
    return _rank_card


def set_rank_device(device: DeviceLike) -> None:
    """Record this rank's card (None: no card); `parallel.mesh` calls it
    when the rank joins its cloud."""
    global _rank_card
    _rank_card = torch.device(device) if device is not None else None


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the caller's, else the process
    default, else ``cuda`` (on a rank, the rank's card). Raises when
    ``cuda`` is asked for (or implied) and no GPU is present."""
    dev = torch.device(device) if device is not None else (_default or torch.device("cuda"))
    if dev.type == "cuda" and dev.index is None and _rank_card is not None:
        dev = _rank_card
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on cuda, and torch.cuda.is_available() is "
            "False; pass device='cpu' or call set_device('cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
