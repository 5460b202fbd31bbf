"""Device selection and the dtype policy.

Counterpart of ``ssip_tpu/runtime/device.py:31-55`` (``resolve_devices``,
``device_label``) and of the precision half of ``runtime/jaxconfig.py``.
The reference CLI flag ``--device auto|cpu|cuda`` maps onto exactly one
``torch.device`` a process: under a process group
(``parallel/distributed.py``) each rank runs on its own card,
``cuda:LOCAL_RANK``, and the mesh is the group's.

Dtype policy (``ssip_tpu/models/resnet.py:9-12``): parameters and BN
statistics stay float32; activations run in float32 (parity mode) or
bfloat16 (throughput mode).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str = "auto") -> torch.device:
    """``auto`` and ``cuda`` → the card; only an explicit ``cpu`` runs on
    the CPU.

    With no card visible, ``auto`` and ``cuda`` raise: the port's entry
    points run on the card unless the caller asks for the CPU, and a run
    never carries on quietly there. Under a process group ``auto`` and
    ``cuda`` are the rank's card.
    """
    name = (device or "auto").lower()
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto" or name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device or 'auto'} needs a CUDA device and none is visible; "
                "pass --device cpu to run on the CPU"
            )
        if name in ("auto", "cuda"):
            from ssip_tpu_torch.parallel.distributed import is_distributed, local_rank

            return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}" if is_distributed() else "cuda")
        return torch.device(name)
    raise ValueError(f"--device must be auto|cpu|cuda, got {device!r}")


def device_label(device: torch.device) -> str:
    """``metadata.json`` device string, in the JAX package's
    ``platform:count`` form: the processes of the group, one device each."""
    from ssip_tpu_torch.parallel.distributed import world_size

    return f"{device.type}:{world_size()}"


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


@contextmanager
def float32_products():
    """Float32 matrix products in true float32 inside the block, the
    caller's setting put back after.

    cuBLAS may run a float32 GEMM in TF32 (about 3 significant digits) when
    ``torch.backends.cuda.matmul.allow_tf32`` is set, which would move the
    analysis stack's ``d2 <= eps²`` neighbourhoods, kNN graphs and k-means
    assignments. Also usable as a decorator.
    """
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
