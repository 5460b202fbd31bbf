"""The port's data parallelism: one process against two gloo ranks on the CPU.

Mirrors ``tests/test_mesh_training.py`` (1 device against 8) with the port's
own ranks: every two-rank run below is the same function of the same seeded
inputs as a one-process run in the test process, and is held to the JAX
package's own 1-vs-N bounds:

- per-step losses atol 1e-5, epoch-0 losses and metrics rtol 1e-4 (SGD, as
  the JAX test isolates the machinery from Adam's sign noise; AdamW runs
  are held at the metric level), later epochs rtol 5e-2;
- eval and pool probabilities rtol 1e-5, atol 1e-7 (``test_mesh_training.py``:
  ``test_eval_invariant_across_device_counts``), predictions equal.

What the ranks compute: the ResNet (global BatchNorm statistics, a padded
last batch and a batch not divisible by two), the tiny ViT and MoE ViT
(routing statistics of the global batch), the head-only pretrain stage,
FixMatch with its EMA teacher (unlabeled batch not divisible by two), the
pool's probabilities and the lanes of ``--num-seeds 2`` split over the
ranks. The two ranks are ``spawn``ed (never forked: the test process has
jax loaded) and joined by ``init_method=file://`` under ``tmp_path``; they
import only ``ssip_tpu_torch`` and return numpy arrays. This module imports
no jax, so the children can import its workers.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

IMG = 32  # the ViTs'
RESNET_IMG = 48  # at 32² layer4's BatchNorm normalizes 1×1 maps of a few rows (``test_torch_train.py``)
LR = 1e-3


# -- spawning ranks ----------------------------------------------------------

def _child(index, world, init_file, out_dir, fn, args, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=index, world_size=world)
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():  # a CLI leaves the group itself
            dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{index}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def spawn_ranks(fn, args, tmp_path: Path, world: int = 2, timeout: float = 240.0, env=None, meanwhile=None):
    """``fn(*args)`` on ``world`` spawned gloo ranks; their results, by rank.
    ``meanwhile()`` runs in this process while they work; with it the
    return value is (rank results, its result)."""
    import torch.multiprocessing as mp

    out = Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = mp.start_processes(
        _child, args=(world, str(out / "init"), str(out), fn, args, env or {}), nprocs=world,
        start_method="spawn", join=False,
    )
    here = meanwhile() if meanwhile is not None else None
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} ranks did not finish in {timeout} s")
    results = []
    for index in range(world):
        with open(out / f"rank{index}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results if meanwhile is None else (results, here)


def cpu_mesh():
    """The process group's mesh, or None outside a group (one process)."""
    from ssip_tpu_torch.parallel.distributed import is_distributed
    from ssip_tpu_torch.parallel.mesh import training_mesh

    return training_mesh(device_type="cpu") if is_distributed() else None


# -- seeded inputs -----------------------------------------------------------

def toy_images(n: int, seed: int = 0, size: int = IMG):
    """The JAX mesh test's toy task: class 1 bright, class 0 dark."""
    rng = np.random.default_rng(seed)
    labels = np.r_[np.zeros(n // 2, np.int64), np.ones(n - n // 2, np.int64)]
    imgs = np.where(
        labels[:, None, None, None] == 1,
        rng.integers(160, 255, (n, size, size, 3)),
        rng.integers(0, 96, (n, size, size, 3)),
    ).astype(np.uint8)
    return imgs, labels


def datasets(n_train: int = 24, n_val: int = 8, size: int = IMG):
    from ssip_tpu_torch.train.engine import DeviceDataset

    imgs, labels = toy_images(32, size=size)
    order = np.r_[np.arange(n_train // 2), 16 + np.arange(n_train - n_train // 2)]
    rest = np.setdiff1d(np.arange(32), order)[:n_val]
    return (DeviceDataset.create(torch.from_numpy(imgs[order]), labels[order]),
            DeviceDataset.create(torch.from_numpy(imgs[rest]), labels[rest]))


def kink_free(tree, bn_bias: float = 4.0):
    """``tests/test_torch_train.py:_kink_free``: conv filters re-centred and
    BatchNorm biases raised, so no ReLU input sits at the kink and
    ``E[x²] − E[x]²`` does not cancel; at the seeded init a 1e-7 change of
    summation order flips ReLU masks and moves single gradients by percent,
    which a few steps amplify past any bound."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            value = kink_free(value, bn_bias)
            if "scale" in value:
                value = {**value, "bias": value["bias"] + np.float32(bn_bias)}
        elif name == "kernel" and value.ndim == 4:
            value = (value - value.mean(axis=(0, 1, 2), keepdims=True)).astype(np.float32)
        out[name] = value
    return out


def fresh_state(arch: str, mesh, optimizer: str = "sgd", fsdp: bool = False, seed: int = 0):
    """Seeded weights (kink-free for a ResNet) in a state on ``mesh``."""
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.parallel.fsdp import shard_model
    from ssip_tpu_torch.train.engine import TrainState

    model = build_model(arch, num_classes=2, compute_dtype=torch.float32, image_size=IMG)
    tree = seeded_init_host(arch, seed, 2, image_size=IMG)  # the size sets a ViT's position table
    load_flax_variables(model, kink_free(tree) if arch.startswith("resnet") else tree)
    if fsdp:
        model = shard_model(model, mesh)
    if optimizer == "sgd":  # lr·g: no normalization, fp-noise stable (the JAX test's choice)
        return TrainState(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
    return TrainState.create(model, LR, 1e-4, mesh=mesh)


def full_state(model) -> dict:
    from ssip_tpu_torch.parallel.fsdp import full_tensor

    return {k: full_tensor(v).detach().numpy().copy() for k, v in model.state_dict().items()}


# -- what the ranks (and the one-process reference) compute ------------------

def train_run(arch: str, n_train: int, batch: int, epochs: int = 1, optimizer: str = "sgd", fsdp: bool = False,
              pretrain: bool = False):
    """train_model: (history, per-step losses of epoch 0, final state)."""
    from ssip_tpu_torch.train import engine

    mesh = cpu_mesh()
    train, val = datasets(n_train, size=RESNET_IMG if arch.startswith("resnet") else IMG)
    state = fresh_state(arch, mesh, optimizer, fsdp)
    steps = []
    original = engine.run_train_epoch

    def recording(*args, **kwargs):
        losses, preds = original(*args, **kwargs)
        steps.append(losses)
        return losses, preds

    engine.run_train_epoch = recording
    try:
        mask = engine.head_only_mask(state.model) if pretrain else None
        state, history = engine.train_model(
            state, train, val, num_epochs=epochs, batch_size=batch, seed=42, stream_name="meshtest",
            early_stopping_patience=10, trainable_mask=mask,
        )
    finally:
        engine.run_train_epoch = original
    return history, steps[0], full_state(state.model)


def eval_run(batch: int):
    from ssip_tpu_torch.train.engine import run_eval_epoch
    from ssip_tpu_torch.train.pseudo_label import pool_probabilities

    mesh = cpu_mesh()
    _, val = datasets(size=RESNET_IMG)
    state = fresh_state("resnet18", mesh, seed=3)
    with torch.no_grad():
        for name, buf in state.model.named_buffers():  # non-trivial running statistics
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    loss, y, pred, prob = run_eval_epoch(state.model, val, batch, mesh)
    pool = torch.from_numpy(np.random.default_rng(4).integers(0, 255, (13, RESNET_IMG, RESNET_IMG, 3), dtype=np.uint8))
    return loss, y, pred, prob, pool_probabilities(state.model, pool, batch, mesh)


def fixmatch_run(fsdp: bool = False, ema_decay: float = 0.9):
    from ssip_tpu_torch.train.consistency import train_fixmatch

    mesh = cpu_mesh()
    train, val = datasets(22, size=RESNET_IMG)
    state = fresh_state("resnet18", mesh, fsdp=fsdp)
    unlabeled = torch.from_numpy(toy_images(12, seed=5, size=RESNET_IMG)[0])
    state, history = train_fixmatch(
        state, train, val, unlabeled, num_epochs=1, batch_size=8, unlabeled_batch_size=5, seed=42,
        stream_name="fixmatch_dp", consistency_weight=1.0, confidence_threshold=0.5, ema_decay=ema_decay,
    )
    return history, full_state(state.model)


def lanes_run():
    from ssip_tpu_torch.train.multi_seed import train_multi_seed

    mesh = cpu_mesh()
    train, val = datasets(22, size=RESNET_IMG)
    states = [fresh_state("resnet18", None, seed=s) for s in (42, 43)]
    states, histories, summary = train_multi_seed(
        states, train, val, seeds=[42, 43], num_epochs=1, batch_size=8, stream_name="baseline", mesh=mesh,
    )
    return histories, summary, [full_state(s.model) for s in states]


def step_on_ranks(variables, images, labels, valid, coeffs, lr: float = 1e-3, wd: float = 1e-4):
    """One AdamW step of a ResNet-18 on this rank's rows of the batch:
    (global loss, predictions of all rows, summed gradients, state after)."""
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.resnet import build_resnet
    from ssip_tpu_torch.train import engine

    mesh = cpu_mesh()
    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    state = engine.TrainState.create(model, lr, wd, mesh=mesh)
    dataset = engine.DeviceDataset.create(torch.from_numpy(images), labels)
    pidx = np.arange(len(images))[None]
    losses, preds = engine.run_train_epoch(state, dataset, pidx, valid[None], None if coeffs is None else coeffs[None])
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return float(losses[0]), preds[0], grads, {k: v.numpy().copy() for k, v in model.state_dict().items()}


def pool_on_ranks(variables, pool, batch: int):
    """The pool's probabilities of a ResNet-18 split over the ranks."""
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.resnet import build_resnet
    from ssip_tpu_torch.train.pseudo_label import pool_probabilities

    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    return pool_probabilities(model, torch.from_numpy(pool), batch, cpu_mesh())


def cli_on_ranks(module: str, argv):
    """A port CLI's ``main(argv)`` on the joined ranks."""
    import importlib

    importlib.import_module(module).main(list(argv))


def batch_of_everything():
    """Every two-rank case of this module in one pair of processes."""
    return {
        "resnet_sgd": train_run("resnet18", 24, 8, epochs=2),
        "resnet_padded": train_run("resnet18", 22, 5),
        "vit": train_run("vit_t16", 22, 5),
        "moe": train_run("vit_moe_t16", 22, 6),
        "pretrain": train_run("resnet18", 22, 8, optimizer="adamw", pretrain=True),
        "eval": eval_run(5),
        "fixmatch": fixmatch_run(),
        "lanes": lanes_run(),
    }


# -- the tests ---------------------------------------------------------------

def one_process(fn, *args):
    """``fn(*args)`` here with the ranks' thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(two ranks' results, the one-process results), computed side by side."""
    return spawn_ranks(batch_of_everything, (), tmp_path_factory.mktemp("dp"),
                       meanwhile=lambda: one_process(batch_of_everything))


@pytest.fixture(scope="module")
def two_ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_rank(runs):
    return runs[1]


def _assert_history(got, want, epochs=1):
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-4, err_msg=key)
        if epochs > 1:
            np.testing.assert_allclose(got[key][1], want[key][1], rtol=5e-2, err_msg=key)
    for key in ("train_acc", "val_acc", "train_f1", "val_f1"):
        np.testing.assert_allclose(got[key][0], want[key][0], err_msg=key)


def test_ranks_agree_with_each_other(two_ranks):
    """Every rank ends with the same state and the same numbers."""
    a, b = two_ranks
    for case in ("resnet_sgd", "resnet_padded", "vit", "moe", "pretrain"):
        for name, value in a[case][2].items():
            np.testing.assert_array_equal(value, b[case][2][name], err_msg=f"{case} {name}")
    np.testing.assert_array_equal(a["eval"][4], b["eval"][4])


@pytest.mark.parametrize("case", ["resnet_sgd", "resnet_padded", "vit", "moe"])
def test_training_matches_one_process(two_ranks, one_rank, case):
    """Step losses atol 1e-5, epoch 0 rtol 1e-4 (epoch 1 5e-2), and the
    parameters and BatchNorm statistics after the run within the JAX test's
    final-parameter bound (rtol 5e-2, atol 5e-4)."""
    got, want = two_ranks[0][case], one_rank[case]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    _assert_history(got[0], want[0], epochs=len(want[0]["train_loss"]))
    for name, value in want[2].items():
        np.testing.assert_allclose(got[2][name], value, rtol=5e-2, atol=5e-4, err_msg=name)


def test_pretrain_stage_matches_one_process(two_ranks, one_rank):
    """The head-only stage (``requires_grad`` toggled each step): the frozen
    backbone bit for bit its init on both, the head and the BatchNorm
    statistics (which still move) at the AdamW bound of the JAX test."""
    got, want = two_ranks[0]["pretrain"], one_rank["pretrain"]
    init = full_state(fresh_state("resnet18", None).model)
    for name, value in want[2].items():
        if name.startswith("fc.") or "running" in name or "num_batches" in name:
            np.testing.assert_allclose(got[2][name], value, rtol=5e-2, atol=5e-4, err_msg=name)
            if name.startswith("fc."):
                assert not np.array_equal(got[2][name], init[name]), name
        else:
            np.testing.assert_array_equal(got[2][name], init[name], err_msg=name)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def test_eval_and_pool_probabilities_match_one_process(two_ranks, one_rank):
    loss, y, pred, prob, pool = two_ranks[0]["eval"]
    loss1, y1, pred1, prob1, pool1 = one_rank["eval"]
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    np.testing.assert_array_equal(y, y1)
    np.testing.assert_array_equal(pred, pred1)
    np.testing.assert_allclose(prob, prob1, rtol=1e-5, atol=1e-7)
    assert pool.shape == pool1.shape == (13, 2)
    np.testing.assert_allclose(pool, pool1, rtol=1e-5, atol=1e-7)


def test_fixmatch_with_ema_matches_one_process(two_ranks, one_rank):
    """The FixMatch epoch (5 unlabeled rows a step over two ranks, so one
    padding row) with the EMA teacher: losses, keep rate and the EMA-applied
    best state."""
    got, want = two_ranks[0]["fixmatch"], one_rank["fixmatch"]
    for key in ("train_loss", "val_loss", "consistency_loss", "consistency_keep_rate"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-4, err_msg=key)
    for name, value in want[1].items():
        np.testing.assert_allclose(got[1][name], value, rtol=5e-2, atol=5e-4, err_msg=name)


def test_seed_lanes_split_over_ranks(two_ranks, one_rank):
    """``--num-seeds 2`` on two ranks: one lane a rank, then every lane on
    every rank; each lane equal to the one-process lane (the lane's own
    training runs alone on its rank: bitwise but for thread counts)."""
    for rank in two_ranks:
        histories, summary, states = rank["lanes"]
        assert [row["seed"] for row in summary] == [42, 43]
        for h, h1 in zip(histories, one_rank["lanes"][0]):
            _assert_history(h, h1)
        for row, row1 in zip(summary, one_rank["lanes"][1]):
            assert row["epochs_run"] == row1["epochs_run"] and row["stopped_early"] == row1["stopped_early"]
            np.testing.assert_allclose(row["best_val_loss"], row1["best_val_loss"], rtol=1e-5)
        for lane, lane1 in zip(states, one_rank["lanes"][2]):
            for name, value in lane1.items():
                np.testing.assert_allclose(lane[name], value, rtol=1e-5, atol=1e-6, err_msg=name)


def test_moe_exports_with_a_symbolic_batch():
    """Outside a data-parallel step the MoE layer reads no group and no
    batch size (a ``float`` of the batch would specialize it): its serving
    program exports with a symbolic batch and runs at another batch."""
    from ssip_tpu_torch.deploy.export import build_serving_fn
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import state_dict_from_flax

    tree = seeded_init_host("vit_moe_t16", 3, 2, image_size=IMG)
    state = {k: torch.from_numpy(v) for k, v in state_dict_from_flax(tree).items()}
    program = build_serving_fn("vit_moe_t16", 2, "float32", state, IMG)
    with torch.no_grad():
        exported = torch.export.export(program, (torch.zeros((2, IMG, IMG, 3), dtype=torch.uint8),),
                                       dynamic_shapes={"images_u8": {0: torch.export.Dim("b", min=1)}})
        images = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (5, IMG, IMG, 3), dtype=np.uint8))
        np.testing.assert_allclose(exported.module()(images).numpy(), program(images).numpy(), rtol=0, atol=1e-6)
