"""The device mesh of the process group, and the sharding rules.

Counterpart of ``ssip_tpu/parallel/mesh.py:1-226``. The JAX package builds
one ``jax.sharding.Mesh`` with a ``data`` and a ``model`` axis and lets
``jit`` partition the program; here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group (one
process a card), with the same axis names, and the data-parallel program is
written out by hand (``train/engine.py``).

- ``MeshSpec``, ``build_mesh``, ``training_mesh``: the JAX names. Without a
  process group ``training_mesh`` is None: one process, the single-device
  program.
- ``pad_to_multiple``, ``shard_batch``: a global batch padded to a multiple
  of the data axis, and this rank's rows of it. ``local_rows`` is the slice.
- ``tp_param_spec``, ``fsdp_param_spec``, ``FSDP_MIN_ELEMENTS``: the JAX
  rules as pure functions of a leaf's Flax key path (a sequence of names)
  and its Flax-layout shape, returning the ``PartitionSpec`` entries as a
  tuple (trailing ``None`` dropped, as ``P()`` prints). ``torch_layout`` maps
  a port parameter's shape onto its Flax layout and ``flax_names`` its
  name onto the Flax names the rules read, so ``fsdp_shard_dim`` and
  ``tp_shard_dim`` give the dimension of the torch parameter that
  ``--fsdp`` and ``--mesh-model`` shard. ``parallel/tensor.py`` applies
  the tensor-parallel rules, ``parallel/fsdp.py`` the FSDP ones.
- ``model_size``, ``model_rank``, ``model_group``: the model axis, as
  ``data_*`` are the data axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data * model`` must equal the process count used."""

    data: int
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


def build_mesh(spec: Optional[MeshSpec] = None, device_type: Optional[str] = None):
    """A 2-D ``(data, model)`` ``DeviceMesh`` over the process group.

    Defaults to every process on the data axis (pure DP). Needs a joined
    group (``parallel/distributed.py:initialize``). ``device_type``: "cuda"
    when the group runs on cards, else "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs a process group: call parallel.distributed.initialize() first")
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec(data=world, model=1)
    if spec.num_devices != world:
        raise ValueError(f"MeshSpec {spec} needs {spec.num_devices} processes, the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (spec.data, spec.model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def training_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """Data-parallel training mesh over ``data`` processes (default: all),
    or None without a process group (one process: no mesh)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if (data or 1) > 1 or model > 1:
            raise RuntimeError(
                f"a mesh of data={data} model={model} needs that many processes: launch with torchrun "
                "or the SSIP_* variables (a process started alone is one rank)"
            )
        return None
    world = dist.get_world_size()
    n = int(data) if data is not None else max(1, world // max(1, model))
    return build_mesh(MeshSpec(data=n, model=model), device_type)


def data_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)))


def data_rank(mesh) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(DATA_AXIS))


def data_group(mesh):
    """The data axis' process group (None without a mesh)."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def model_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)))


def model_rank(mesh) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(MODEL_AXIS))


def model_group(mesh):
    """The model axis' process group (None without a mesh)."""
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest padded size >= n divisible by ``multiple``."""
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return ((n + multiple - 1) // multiple) * multiple


def local_rows(mesh, global_rows: int) -> slice:
    """This rank's rows of a padded global batch of ``global_rows``."""
    n = data_size(mesh)
    if global_rows % n:
        raise ValueError(f"{global_rows} rows do not split over a data axis of {n}")
    per = global_rows // n
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh, array, pad_value: float | int = 0):
    """This rank's rows of a host (numpy) or device (torch) batch.

    Pads the leading axis up to a multiple of the data-axis size (callers
    mask the padding out) and returns ``(this rank's rows, original
    length)``, as the JAX function returns the sharded array."""
    n = array.shape[0]
    padded = pad_to_multiple(max(n, 1), data_size(mesh))
    if padded != n:
        if isinstance(array, torch.Tensor):
            pad = torch.full((padded - n, *array.shape[1:]), pad_value, dtype=array.dtype, device=array.device)
            array = torch.cat([array, pad])
        else:
            pad_width = [(0, padded - n)] + [(0, 0)] * (array.ndim - 1)
            array = np.pad(array, pad_width, constant_values=pad_value)
    return array[local_rows(mesh, padded)], n


def _canonical(spec: list) -> Tuple:
    while spec and spec[-1] is None:  # canonical form: P() not P(None,...)
        spec.pop()
    return tuple(spec)


def tp_param_spec(path: Sequence[str], shape: Sequence[int], model_par: int) -> Tuple:
    """Tensor-parallel spec of one parameter or optimizer leaf (Flax path
    and layout).

    Wide conv kernels (HWIO, 128 output channels or more) shard their
    output axis over the model axis; the classifier ``fc`` kernel its input
    axis; a ViT block's ``qkv`` and ``mlp_1`` are column-parallel (kernel
    axis 1 and their biases), ``out`` and ``mlp_2`` row-parallel (kernel
    axis 0); an MoE block's expert leaves (``w_in``, ``w_out``, ``b_in``,
    ``b_out``) shard their leading expert axis. Everything else replicates.
    """
    names = [str(p) for p in path]
    ndim = len(shape)
    if ndim == 4 and shape[-1] % model_par == 0 and shape[-1] >= 128:
        return (None, None, None, MODEL_AXIS)
    if names[-2:] == ["fc", "kernel"] and ndim == 2 and shape[0] % model_par == 0:
        return (MODEL_AXIS,)
    if names[-1] == "kernel" and ndim == 2:
        mod = names[-2]
        if mod in ("qkv", "mlp_1") and shape[1] % model_par == 0:
            return (None, MODEL_AXIS)
        if mod in ("out", "mlp_2") and shape[0] % model_par == 0:
            return (MODEL_AXIS,)
    if names[-1] == "bias" and ndim == 1 and names[-2] in ("qkv", "mlp_1") and shape[0] % model_par == 0:
        return (MODEL_AXIS,)
    if "moe" in names and names[-1] in ("w_in", "w_out", "b_in", "b_out") and ndim >= 2 and shape[0] % model_par == 0:
        return (MODEL_AXIS,)
    return ()


# Leaves below this many elements replicate under FSDP: sharding tiny
# tensors buys no memory and costs a collective launch each.
FSDP_MIN_ELEMENTS = 65536


def fsdp_param_spec(path: Sequence[str], shape: Sequence[int], data_par: int, model_par: int) -> Tuple:
    """ZeRO-3 spec: the tensor-parallel rules first, then the largest
    remaining axis divisible by ``data_par`` of every leaf of at least
    ``FSDP_MIN_ELEMENTS`` elements takes the data axis (the first such
    axis on a tie)."""
    ndim = len(shape)
    spec = list(tp_param_spec(path, shape, model_par) if model_par > 1 else ())
    spec += [None] * (ndim - len(spec))
    if int(np.prod(shape, dtype=np.int64)) >= FSDP_MIN_ELEMENTS and ndim > 0:
        candidates = [d for d in range(ndim) if spec[d] is None and shape[d] % data_par == 0]
        if candidates:
            spec[max(candidates, key=lambda d: shape[d])] = DATA_AXIS
    return _canonical(spec)


def torch_layout(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """``perm`` with Flax axis ``i`` = torch axis ``perm[i]`` for the port
    parameter ``name`` of ``shape`` (``models/port.py``'s layouts): a 4-D
    conv weight is OIHW against HWIO, a 2-D ``weight`` (a ``Linear``: the
    ResNet's ``fc``, every ViT Dense and router) ``[out, in]`` against
    ``[in, out]``; every other leaf (an MoE layer's ``[E, …]`` experts
    included) has one layout."""
    if len(shape) == 4:
        return (2, 3, 1, 0)
    if len(shape) == 2 and name.endswith("weight"):
        return (1, 0)
    return tuple(range(len(shape)))


# torch module names → the Flax module names the tensor-parallel rules read
_FLAX_MODULES = {"fc": "fc", "head": "fc", "out_proj": "out", "mlp.0": "mlp_1", "mlp.3": "mlp_2"}
_FLAX_QKV = {"in_proj_weight": ("qkv", "kernel"), "in_proj_bias": ("qkv", "bias")}


def flax_names(name: str) -> Tuple[str, ...]:
    """The Flax key path (as far as the rules read it) of the port
    parameter ``name``: the ResNet's ``fc`` and the ViT's ``heads.head``
    are ``fc``; ``in_proj_{weight,bias}`` is ``qkv``; ``out_proj``,
    ``mlp.0`` and ``mlp.3`` are ``out``, ``mlp_1`` and ``mlp_2``; an MoE
    block's leaves sit under ``moe``; a ``weight`` is a ``kernel`` (the
    rules read the kernels' names only)."""
    parts = name.split(".")
    if parts[-1] in _FLAX_QKV:
        return (*parts[:-1], *_FLAX_QKV[parts[-1]])
    leaf = "kernel" if parts[-1] == "weight" else parts[-1]
    for n in (2, 1):  # "mlp.0", then "fc", "head", "out_proj"
        module = ".".join(parts[-1 - n : -1])
        if len(parts) > n and module in _FLAX_MODULES:
            return (*parts[: -1 - n], _FLAX_MODULES[module], leaf)
    return tuple(parts)


def _flax_shape(name: str, shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    perm = torch_layout(name, shape)
    return perm, tuple(shape[p] for p in perm)


def tp_shard_dim(name: str, shape: Sequence[int], model_par: int) -> Optional[int]:
    """The dimension ``--mesh-model`` shards of the torch parameter
    ``name`` of (whole) ``shape`` (``tp_param_spec`` on its Flax names and
    layout), or None for a leaf every model rank holds whole."""
    if model_par <= 1:
        return None
    perm, flax_shape = _flax_shape(name, shape)
    spec = tp_param_spec(flax_names(name), flax_shape, model_par)
    return perm[spec.index(MODEL_AXIS)] if MODEL_AXIS in spec else None


def fsdp_shard_dim(name: str, shape: Sequence[int], data_par: int, model_par: int = 1) -> Optional[int]:
    """The dimension ``--fsdp`` shards of the torch parameter ``name`` of
    (whole) ``shape`` (``fsdp_param_spec`` on its Flax names and layout,
    the tensor-parallel rules first at ``model_par`` > 1), or None for a
    leaf that stays whole."""
    perm, flax_shape = _flax_shape(name, shape)
    spec = fsdp_param_spec(flax_names(name), flax_shape, data_par, model_par)
    return perm[spec.index(DATA_AXIS)] if DATA_AXIS in spec else None
