"""Rank workers of the model-axis tests (``--mesh-model``, GPipe, ring attention).

Jax-free, like ``tests/test_torch_data_parallel.py``: the ranks are
``spawn``ed children that import this module, and the test modules that
hold them to the JAX package import jax. Each function builds what it
needs from seeded numpy inputs passed in, runs on the joined gloo group
(or in one process without one) and returns numpy arrays.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_data_parallel import RESNET_IMG, cli_on_ranks, datasets, kink_free  # noqa: F401

STEP_ROWS = 8  # 2 of them padding (valid False): the second data rank's last two
LR = 1e-3  # the multichip dryrun's SGD step
# tensor-parallel cases: name → (arch, image size, FSDP over the data axis)
CASES = {
    "resnet-tp": ("resnet18", 48, False),
    "vit-tp": ("vit_t16", 32, False),  # 3 heads: the qkv columns gathered
    "vit-tp-heads": ("vit_s16", 32, False),  # 6 heads: 3 a rank
    "vit-ep": ("vit_moe_t16", 32, False),  # 4 of 8 experts a rank
    "tp-fsdp": ("vit_t16", 32, True),
}
MESH = (2, 2)  # data × model
CLI_SIZE = 48  # the training CLIs' images: layer4's BatchNorm sees 2 × 2 maps


def model_mesh(data: int, model: int):
    """The (data, model) mesh of the joined group, None without one."""
    from ssip_tpu_torch.parallel.distributed import is_distributed
    from ssip_tpu_torch.parallel.mesh import training_mesh

    return training_mesh(data, model, device_type="cpu") if is_distributed() else None


def step_inputs(size: int, seed: int = 0):
    """(images uint8 [8, size, size, 3], labels, valid): the last two rows padding."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (STEP_ROWS, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, STEP_ROWS)
    return images, labels, np.arange(STEP_ROWS) < STEP_ROWS - 2


def _whole_grads(model) -> dict:
    from ssip_tpu_torch.parallel.fsdp import full_tensor
    from ssip_tpu_torch.parallel.tensor import whole_tensor

    return {n: whole_tensor(model, n, full_tensor(p.grad)).detach().numpy().copy()
            for n, p in model.named_parameters()}


def tp_step(arch: str, variables, inputs, mesh_shape, fsdp: bool = False):
    """One SGD step (lr ``LR``) of ``arch`` from ``variables`` on the 8
    rows, sliced over the model axis of ``mesh_shape`` (and FSDP-sharded
    over its data axis): (loss, predictions, whole gradients, whole state
    after, the local gradients of the leaves the model axis leaves whole)."""
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.parallel import fsdp as fsdp_mod
    from ssip_tpu_torch.parallel.tensor import shard_model, whole_state_dict
    from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, run_train_epoch

    images, labels, valid = inputs
    mesh = model_mesh(*mesh_shape) if mesh_shape else None
    model = build_model(arch, num_classes=2, compute_dtype=torch.float32, image_size=images.shape[1])
    load_flax_variables(model, variables)
    model = shard_model(model, mesh)
    if fsdp:
        model = fsdp_mod.shard_model(model, mesh)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
    dataset = DeviceDataset.create(torch.from_numpy(images), labels)
    losses, preds = run_train_epoch(state, dataset, np.arange(STEP_ROWS)[None], valid[None], None)
    sliced = getattr(model, "_ssip_tp", {})
    replicated = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()
                  if n not in sliced and not fsdp}
    state_after = {k: v.detach().numpy().copy() for k, v in whole_state_dict(model).items()}
    return float(losses[0]), preds[0], _whole_grads(model), state_after, replicated


def tp_train_run(mesh_shape, epochs: int = 2):
    """``test_mesh_training.py:192-232``'s run: resnet18 (kink-free seeded
    weights) trained ``epochs`` epochs by ``train_model`` with SGD on 24
    images in batches of 8, sliced over ``mesh_shape``'s model axis:
    (history, whole state after)."""
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.parallel.tensor import shard_model, whole_state_dict
    from ssip_tpu_torch.train.engine import TrainState, train_model

    mesh = model_mesh(*mesh_shape) if mesh_shape else None
    train, val = datasets(24, size=RESNET_IMG)
    model = build_model("resnet18", num_classes=2, compute_dtype=torch.float32)
    load_flax_variables(model, kink_free(seeded_init_host("resnet18", 0, 2)))
    model = shard_model(model, mesh)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
    state, history = train_model(state, train, val, num_epochs=epochs, batch_size=8, seed=42, stream_name="meshtest",
                                 early_stopping_patience=10)
    return history, {k: v.detach().numpy().copy() for k, v in whole_state_dict(state.model).items()}


def cli_join_again(out_dir: str, tag: str) -> None:
    """A CLI leaves the group at its end: join a new one (a ``file://``
    coordinator under ``out_dir``) for the next CLI."""
    import torch.distributed as dist

    if not dist.is_initialized():
        os.environ.update(SSIP_COORDINATOR=f"file://{out_dir}/init_{tag}",
                          SSIP_NUM_PROCESSES=os.environ["SSIP_TEST_WORLD"],
                          SSIP_PROCESS_ID=os.environ["SSIP_TEST_RANK"])


def note_rank() -> None:
    """Keep this rank and the world size for a later CLI's own join."""
    import torch.distributed as dist

    os.environ["SSIP_TEST_RANK"] = str(dist.get_rank())
    os.environ["SSIP_TEST_WORLD"] = str(dist.get_world_size())


def cli_runs(tree: str, out_dir: str) -> dict:
    """The two training CLIs (``--mesh-model 2`` on a group), and the
    supervised one on vit_t16 with ``--fsdp`` too, each into its own output
    directory under ``out_dir``: their directories."""
    from ssip_tpu_torch.parallel.distributed import is_distributed

    grouped = is_distributed()
    if grouped:
        note_rank()
    common = ["--strong-data-dir", f"{tree}/avec_labels", "--device", "cpu", "--image-size", str(CLI_SIZE),
              "--batch-size", "4", *(["--mesh-model", "2"] if grouped else [])]
    out = {}
    # FSDP first, on the launch's own group: a DeviceMesh sliced for FSDP
    # (``mesh["data"]``) is cached, and a group joined again after a CLI
    # left its own would reach it
    for tag, module, argv in (
        # FSDP over the data axis on the model axis' slices (one process: unsharded)
        ("fsdp", "ssip_tpu_torch.cli.supervised_training",
         ["--arch", "vit_t16", "--baseline-epochs", "2", *(["--fsdp"] if grouped else [])]),
        ("supervised", "ssip_tpu_torch.cli.supervised_training", ["--baseline-epochs", "2"]),
        ("semi", "ssip_tpu_torch.cli.semi_supervised_training",
         ["--weak-data-dir", f"{tree}/sans_label", "--baseline-epochs", "1", "--weak-pretrain-epochs", "1",
          "--finetune-epochs", "1", "--pseudo-threshold", "0.0", "--consistency-weight", "1.0",
          "--consistency-threshold", "0.5", "--ema-decay", "0.9"]),
    ):
        if grouped:
            cli_join_again(out_dir, tag)
        out[tag] = str(Path(out_dir) / f"{tag}_{'ranks' if grouped else 'one'}")
        cli_on_ranks(module, [*common, *argv, "--output-dir", out[tag]])
    return out


def tiny_vit(num_classes=2, layers: int = 4, heads: int = 2):
    """The JAX PP/SP tests' tiny ViT (patch 8, width 64, MLP 128) at 32²."""
    from ssip_tpu_torch.models.vit import VisionTransformer

    return VisionTransformer(patch_size=8, hidden_dim=64, num_layers=layers, num_heads=heads, mlp_dim=128,
                             num_classes=num_classes, image_size=32)


def plain_vit(tree, num_classes=2):
    from ssip_tpu_torch.models.port import load_flax_variables

    model = tiny_vit(num_classes)
    load_flax_variables(model, tree)
    return model


def tp_resume_run(out_dir: str, form: str):
    """The tiny ViT (2 heads: the qkv rows regrouped, a head a rank) with
    AdamW, 2 epochs straight, then 1 epoch with a resume snapshot (the
    ``form``: "file" or "orbax") resumed to 2: (straight, resumed), each
    (history, whole state after)."""
    from ssip_tpu_torch.parallel.tensor import whole_state_dict
    from ssip_tpu_torch.train.engine import TrainState, train_model

    mesh = model_mesh(*MESH)
    train, val = datasets(8, 4)

    def run(epochs, resume_path):
        torch.manual_seed(0)
        state = TrainState.create(tiny_vit(), 1e-3, 1e-4, mesh=mesh)
        state, history = train_model(state, train, val, num_epochs=epochs, batch_size=4, seed=42,
                                     stream_name="tp_resume", early_stopping_patience=10, resume_path=resume_path)
        return history, {k: v.detach().numpy().copy() for k, v in whole_state_dict(state.model).items()}

    if form == "orbax":
        os.environ["SSIP_SNAPSHOT_FORMAT"] = "orbax"
    try:
        path = Path(out_dir) / f"tp_resume_{form}.torchsnap"
        straight = run(2, None)
        run(1, path)
        return straight, run(2, path)
    finally:
        os.environ.pop("SSIP_SNAPSHOT_FORMAT", None)


def tp_batch(variables, inputs, tree, out_dir):
    """Every tensor-parallel case on the ranks of one launch."""
    results = {case: tp_step(arch, variables[case], inputs[case], MESH, fsdp)
               for case, (arch, _, fsdp) in CASES.items()}
    results["trajectory"] = tp_train_run(MESH)
    results["resume"] = {form: tp_resume_run(out_dir, form) for form in ("file", "orbax")}
    results["cli"] = cli_runs(tree, out_dir)  # last: a CLI leaves the group
    return results


# -- GPipe and ring attention -------------------------------------------------

def _whole(model, tensors: dict) -> dict:
    """Parameter name → tensor of this rank, whole: a pipelined ViT's
    stages gathered (a collective)."""
    if hasattr(model, "gather_stages"):
        tensors = model.gather_stages(tensors)
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def vit_forward_and_grads(model, x, labels):
    """(logits of ``x``, the mean cross-entropy, its whole gradients; the
    gradients a model lists as partial over the model axis summed first)."""
    import torch.nn.functional as F

    from ssip_tpu_torch.train.engine import TrainState, sync_gradients

    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    sync_gradients(TrainState(model, None, mesh=getattr(model, "_ssip_mesh", None)))
    return logits.detach().numpy(), float(loss.detach()), _whole(model, {n: p.grad for n, p in model.named_parameters()})


def vit_sgd_step(model, images, labels, mesh, lr: float = 0.1):
    """One engine step (eval preprocess, SGD ``lr``) on all rows: (loss,
    argmax, whole state after)."""
    from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, run_train_epoch

    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=lr), mesh=mesh)
    n = len(images)
    losses, preds = run_train_epoch(state, DeviceDataset.create(torch.from_numpy(images), labels),
                                    np.arange(n)[None], np.ones((1, n), bool), None)
    return float(losses[0]), preds[0], _whole(model, dict(model.state_dict()))


def _parallel(kind: str, model, mesh, microbatches: int = 2):
    from ssip_tpu_torch.parallel.pipeline import make_pp_apply_fn
    from ssip_tpu_torch.parallel.sequence import make_sp_apply_fn

    out = make_pp_apply_fn(model, mesh, microbatches) if kind == "pp" else make_sp_apply_fn(model, mesh)
    out._ssip_mesh = mesh
    return out


def vit_parallel_batch(kind: str, tree, features_tree, x, labels, images):
    """Every check of ``kind`` ("pp": GPipe, "sp": ring attention) on the
    ranks of one launch, at model 4 (data 1) and data 2 × model 2."""
    mesh4, mesh22 = model_mesh(1, 4), model_mesh(2, 2)
    out = {"forward": {}, "bad_shape": None}
    counts = (1, 2, 4) if kind == "pp" else (2,)
    for mesh, label in ((mesh4, "1x4"), (mesh22, "2x2")):
        for mb in counts:
            with torch.no_grad():
                out["forward"][(label, mb)] = _parallel(kind, plain_vit(tree), mesh, mb)(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        out["features"] = _parallel(kind, plain_vit(features_tree, None), mesh4)(torch.from_numpy(x)).numpy()
    out["grads"] = vit_forward_and_grads(_parallel(kind, plain_vit(tree), mesh4), x, labels)
    model = _parallel(kind, plain_vit(tree), mesh4)
    out["local_blocks"] = len(model.encoder.layers)
    out["step"] = vit_sgd_step(model, images, labels, mesh4)
    out["step_2x2"] = vit_sgd_step(_parallel(kind, plain_vit(tree), mesh22), images, labels, mesh22)
    if kind == "pp":
        try:  # batch 8 in 3 microbatches: refused before any collective
            _parallel(kind, plain_vit(tree), mesh4, 3)(torch.from_numpy(x))
        except ValueError as exc:
            out["bad_shape"] = str(exc)
    return out


def ring_attention_batch(qkv_by_seq: dict, grad_case):
    """The ring (4 shards) on each sequence's padded q, k, v [B, H, S, Dh]
    and its gradients of ``Σ o²`` for ``grad_case``: this rank's output
    blocks gathered whole."""
    from ssip_tpu_torch.parallel import tensor
    from ssip_tpu_torch.parallel.sequence import make_ring_attention

    axis = tensor.model_axis(model_mesh(1, 4))
    out = {}
    for seq, arrays in {**qkv_by_seq, "grad": grad_case}.items():
        length = arrays[0].shape[2] if seq != "grad" else grad_case[0].shape[2]
        t = -(-length // axis.size)
        padded = [torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 0, t * axis.size - length)) for a in arrays]
        local = [p[:, :, axis.rank * t : (axis.rank + 1) * t].clone().requires_grad_(seq == "grad") for p in padded]
        o = make_ring_attention(axis.size, length, axis)(*local)
        whole = tensor.gather(o, axis, dim=2)
        if seq != "grad":
            out[seq] = whole.detach().numpy()
            continue
        (whole[:, :, :length] ** 2).sum().backward()
        out[seq] = [tensor.gather(g.grad, axis, dim=2)[:, :, :length].numpy() for g in local]
    return out


def sp_batch(tree, features_tree, x, labels, images, qkv_by_seq, grad_case):
    """The sequence-parallel ViT's checks and the ring's, in one launch."""
    return {"model": vit_parallel_batch("sp", tree, features_tree, x, labels, images),
            "ring": ring_attention_batch(qkv_by_seq, grad_case)}
