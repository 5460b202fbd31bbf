"""Device selection and the dtype policy.

Counterpart of ``ssip_tpu/runtime/device.py:31-55`` (``resolve_devices``,
``device_label``) and of the precision half of ``runtime/jaxconfig.py``.
The reference CLI flag ``--device auto|cpu|cuda`` maps onto exactly one
``torch.device``; there is no mesh in this slice.

Dtype policy (``ssip_tpu/models/resnet.py:9-12``): parameters and BN
statistics stay float32; activations run in float32 (parity mode) or
bfloat16 (throughput mode).
"""

from __future__ import annotations

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str = "auto") -> torch.device:
    """``auto`` → ``cuda`` when a card is visible, else ``cpu``.

    An explicit ``cuda`` with no card raises: a run that asked for the GPU
    never carries on quietly on the CPU.
    """
    name = (device or "auto").lower()
    if name == "auto":
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device} requested but no CUDA device is visible")
        return torch.device(name)
    raise ValueError(f"--device must be auto|cpu|cuda, got {device!r}")


def device_label(device: torch.device) -> str:
    """``metadata.json`` device string, in the JAX package's
    ``platform:count`` form (one device per run here)."""
    return f"{device.type}:1"


def compute_dtype(name: str) -> torch.dtype:
    try:
        return COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}"
        ) from None


def configure_precision(name: str) -> None:
    """Pin float32 math to true float32 for ``--compute-dtype float32``.

    cuDNN runs float32 convolutions in TF32 by default (about 3 significant
    digits), which would break the 1e-4 parity the float32 mode promises;
    matmuls are set too so the policy does not hinge on a default.
    bfloat16 runs leave both switches as they are.
    """
    if name == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
