"""Device choice for the CLI (counterpart of commands/main.py:61-67).

The port runs on ``cuda``. Hosts without a card stop with a typed error
unless ``PLATANUS_B_TPU_TORCH_DEVICE=cpu`` asks for the CPU explicitly, in
which case every kernel wrapper takes its plain PyTorch version. Under an
initialized process group (torchrun) each rank takes card
``LOCAL_RANK % device_count``, so ranks share a card when there are more
ranks than cards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .utils.errors import PlatanusError

ENV_VAR = "PLATANUS_B_TPU_TORCH_DEVICE"


class DeviceError(PlatanusError):
    """No usable device for the requested run."""

    exit_id = 1


def select_device() -> torch.device:
    want = os.environ.get(ENV_VAR, "").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise DeviceError(f"{ENV_VAR}={want!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device available; set "
            f"{ENV_VAR}=cpu to run the plain PyTorch path on the CPU")
    if not dist.is_initialized():
        return torch.device("cuda")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
