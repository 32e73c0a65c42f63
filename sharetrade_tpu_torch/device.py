"""Device selection: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(requested: torch.device | str | None = None
                   ) -> torch.device:
    """``requested`` as a device, ``cuda`` when None. Raises when a CUDA
    device is wanted and none is visible — the port never falls back to the
    CPU on its own; pass ``device="cpu"`` (CLI: ``--device cpu``) for that."""
    device = torch.device("cuda" if requested is None else requested)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sharetrade_tpu_torch runs on a CUDA device and none is visible; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device
