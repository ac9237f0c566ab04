"""shifu_tpu_torch — the PyTorch/CUDA port of ``shifu_tpu``.

The package mirrors ``shifu_tpu``'s module paths and names so each piece
has an obvious counterpart; it reads and writes the same
``ModelConfig.json`` / ``ColumnConfig.json`` / model files.  It imports
``torch`` and ``numpy`` only — never ``jax``, ``pandas`` or ``shifu_tpu``.

Entry points run on the card: ``device`` defaults to ``cuda`` and a missing
CUDA runtime raises instead of quietly falling back to the CPU.  Pass
``device="cpu"`` (the CLI's ``--device cpu``) to run the plain PyTorch
versions on the host, as the parity tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available — pass device='cpu' (CLI: --device cpu) "
            "to run the port on the CPU")
    return dev
