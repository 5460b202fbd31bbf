"""``--fsdp`` and the sharded (DCP) snapshots on two gloo ranks on the CPU.

Mirrors ``tests/test_fsdp.py`` and ``tests/test_orbax_ckpt.py``:

- placements: every parameter of at least ``FSDP_MIN_ELEMENTS`` elements is
  a ``DTensor`` sharded on ``fsdp_shard_dim``'s dimension, every smaller
  one stays whole, AdamW's moments follow their parameter (half the
  elements on each rank), and the two kinds are two parameter groups (a
  foreach kernel, AdamW's on the card, takes one kind a call);
- the FSDP step equals the replicated step (loss and parameters atol 1e-5,
  the JAX test's bound) and the one-process step, for the ResNet, the ViT
  and the MoE ViT, on the head-only pretrain stage and in FixMatch with
  its EMA teacher;
- the final ``.pt`` is gathered whole and equals the one-process one (the
  same bound);
- the sharded snapshot: round trip in one process, round trip of an FSDP
  state restored into the template's placements, the variable's dispatch
  and a directory's detection without it, and an interrupted run resumed
  through it (the JAX test's rtol 1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import (
    IMG, RESNET_IMG, cpu_mesh, datasets, fixmatch_run, fresh_state, full_state, one_process, spawn_ranks, train_run,
)
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

DRIVER = {
    "epoch": 3,
    "history": {"train_loss": [1.0, 0.5]},
    "best_val_loss": 0.4,
    "early_patience": 1,
    "plateau_best": 0.4,
    "plateau_bad": 0,
    "finished": False,
}


def placements(arch: str):
    """(name → (sharded dim or None, local numel, numel)) of the FSDP
    parameters and of the AdamW moments after one step."""
    from torch.distributed.tensor import DTensor

    mesh = cpu_mesh()
    state = fresh_state(arch, mesh, "adamw", fsdp=True)
    train, _ = datasets(8, size=RESNET_IMG if arch.startswith("resnet") else IMG)
    from ssip_tpu_torch.train.engine import epoch_plan, run_train_epoch

    plan = epoch_plan(train, seed=0, epoch=0, stream_name="fsdp", balanced=False, batch_size=8)
    run_train_epoch(state, train, *plan)

    def where(t):
        if isinstance(t, DTensor):
            return t.placements[0].dim, t.to_local().numel(), t.numel()
        return None, t.numel(), t.numel()

    params = {n: where(p) for n, p in state.model.named_parameters()}
    moments = {n: where(state.optimizer.state[p]["exp_avg"]) for n, p in state.model.named_parameters()}
    # a foreach kernel (AdamW's on the card) takes one kind of tensor a group
    kinds = [sorted({type(p).__name__ for p in group["params"]}) for group in state.optimizer.param_groups]
    return params, moments, kinds


def checkpoint_run(out_dir: str, fsdp: bool):
    """One epoch with the per-improvement ``.pt``; its bytes come back."""
    from ssip_tpu_torch.train.checkpoints import save_checkpoint
    from ssip_tpu_torch.train.engine import train_model
    from pathlib import Path

    mesh = cpu_mesh()
    train, val = datasets(22, size=RESNET_IMG)
    state = fresh_state("resnet18", mesh, fsdp=fsdp)
    path = Path(out_dir) / f"ckpt_{'fsdp' if fsdp else 'plain'}_{mesh is not None}.pt"
    train_model(state, train, val, num_epochs=1, batch_size=8, seed=42, stream_name="ckpt",
                checkpoint_fn=lambda s: save_checkpoint(path, s.model))
    if not path.exists():  # rank 0 alone writes
        return None
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


def orbax_roundtrip(out_dir: str):
    """An FSDP state (after a step, so the moments exist) saved as shards
    and restored into a fresh FSDP template: (saved, restored) values and
    whether every restored tensor kept the template's placement."""
    from pathlib import Path

    from torch.distributed.tensor import DTensor

    from ssip_tpu_torch.train.checkpoints import Snapshot
    from ssip_tpu_torch.train.engine import epoch_plan, run_train_epoch
    from ssip_tpu_torch.train.orbax_ckpt import load_train_snapshot_orbax, save_train_snapshot_orbax

    mesh = cpu_mesh()
    train, _ = datasets(8, size=RESNET_IMG)
    state = fresh_state("resnet18", mesh, "adamw", fsdp=True)
    run_train_epoch(state, train, *epoch_plan(train, seed=0, epoch=0, stream_name="o", balanced=False, batch_size=8))
    path = Path(out_dir) / "snap_fsdp"
    save_train_snapshot_orbax(path, Snapshot.take(state), DRIVER)
    template = fresh_state("resnet18", mesh, "adamw", fsdp=True)
    snapshot, driver = load_train_snapshot_orbax(path, template)
    snapshot.restore(template)
    kept = all(
        isinstance(got, DTensor) == isinstance(want, DTensor)
        and (not isinstance(got, DTensor) or got.placements == want.placements)
        for got, want in zip(template.model.state_dict().values(), state.model.state_dict().values())
    )
    moments = [template.optimizer.state[p]["exp_avg"] for p in template.model.parameters()]
    kept = kept and all(isinstance(m, DTensor) == isinstance(p, DTensor)
                        for m, p in zip(moments, template.model.parameters()))
    return (full_state(state.model), full_state(template.model), driver, kept,
            [float(m.full_tensor().abs().sum()) if isinstance(m, DTensor) else float(m.abs().sum()) for m in moments],
            [float(state.optimizer.state[p]["exp_avg"].full_tensor().abs().sum())
             if isinstance(p, DTensor) else float(state.optimizer.state[p]["exp_avg"].abs().sum())
             for p in state.model.parameters()])


def everything(out_dir: str):
    return {
        "placements": {arch: placements(arch) for arch in ("resnet18", "vit_t16", "vit_moe_t16")},
        "fsdp": {arch: train_run(arch, 22, 8, fsdp=True) for arch in ("resnet18", "vit_t16", "vit_moe_t16")},
        "replicated": train_run("resnet18", 22, 8),
        "pretrain": train_run("resnet18", 22, 8, optimizer="adamw", pretrain=True, fsdp=True),
        "pretrain_replicated": train_run("resnet18", 22, 8, optimizer="adamw", pretrain=True),
        "fixmatch": fixmatch_run(fsdp=True),
        "checkpoint": checkpoint_run(out_dir, fsdp=True),
        "orbax": orbax_roundtrip(out_dir),
    }


def reference():
    return {
        "fsdp": {arch: train_run(arch, 22, 8) for arch in ("resnet18", "vit_t16", "vit_moe_t16")},
        "fixmatch": fixmatch_run(),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    (ranks, ref) = spawn_ranks(everything, (str(out),), out, meanwhile=lambda: one_process(reference))
    ref["checkpoint"] = one_process(checkpoint_run, str(out), False)
    return ranks, ref


@pytest.mark.parametrize("arch", ["resnet18", "vit_t16", "vit_moe_t16"])
def test_placements_follow_the_spec_and_moments_follow_them(runs, arch):
    from ssip_tpu_torch.parallel.mesh import FSDP_MIN_ELEMENTS, fsdp_shard_dim

    params, moments, kinds = runs[0][0]["placements"][arch]
    assert kinds == [["DTensor"], ["Parameter"]]
    assert any(dim is not None for dim, _, _ in params.values())
    shapes = {n: tuple(p.shape) for n, p in fresh_state(arch, None).model.named_parameters()}
    for name, (dim, local, total) in params.items():
        assert dim == fsdp_shard_dim(name, shapes[name], 2), name
        if dim is None:
            assert local == total, name
        else:
            assert total >= FSDP_MIN_ELEMENTS and 2 * local == total, name
        assert moments[name] == (dim, local, total), name


@pytest.mark.parametrize("arch", ["resnet18", "vit_t16", "vit_moe_t16"])
def test_fsdp_training_matches_replicated_and_one_process(runs, arch):
    """Step losses atol 1e-5, epoch 0 rtol 1e-4 against one process, and
    the final parameters atol 1e-5 against the replicated two-rank run (the
    JAX test's bound; SGD) for the ResNet."""
    ranks, ref = runs
    got, want = ranks[0]["fsdp"][arch], ref["fsdp"][arch]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[0][key][0], want[0][key][0], rtol=1e-4, err_msg=key)
    for name, value in want[2].items():
        np.testing.assert_allclose(got[2][name], value, rtol=5e-2, atol=5e-4, err_msg=name)
    if arch == "resnet18":
        for name, value in ranks[0]["replicated"][2].items():
            np.testing.assert_allclose(got[2][name], value, rtol=0, atol=1e-5, err_msg=name)
    for name, value in got[2].items():
        np.testing.assert_array_equal(value, ranks[1]["fsdp"][arch][2][name], err_msg=name)


def test_fsdp_pretrain_stage_matches_replicated(runs):
    """The head-only stage under FSDP: AdamW on the sharded moments equals
    the replicated two-rank run's (atol 1e-5), the frozen backbone bit for
    bit its init."""
    ranks, _ = runs
    got, want = ranks[0]["pretrain"], ranks[0]["pretrain_replicated"]
    init = full_state(fresh_state("resnet18", None).model)
    for name, value in want[2].items():
        np.testing.assert_allclose(got[2][name], value, rtol=0, atol=1e-5, err_msg=name)
        if not (name.startswith("fc.") or "running" in name or "num_batches" in name):
            np.testing.assert_array_equal(got[2][name], init[name], err_msg=name)


def test_fsdp_fixmatch_with_ema_matches_one_process(runs):
    """The EMA teacher kept in the parameters' placements (copied in and
    out around the teacher's forward): losses rtol 1e-4, the EMA-applied
    best state at the JAX test's final-parameter bound."""
    ranks, ref = runs
    got, want = ranks[0]["fixmatch"], ref["fixmatch"]
    for key in ("train_loss", "val_loss", "consistency_loss", "consistency_keep_rate"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-4, err_msg=key)
    for name, value in want[1].items():
        np.testing.assert_allclose(got[1][name], value, rtol=5e-2, atol=5e-4, err_msg=name)


def test_fsdp_checkpoint_is_gathered_whole(runs):
    """The per-improvement ``.pt`` written under FSDP holds whole CPU
    tensors with the torchvision names and equals the one-process one."""
    ranks, ref = runs
    got, want = ranks[0]["checkpoint"], ref["checkpoint"]
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].shape == value.shape, name
        np.testing.assert_allclose(got[name], value, rtol=5e-2, atol=5e-4, err_msg=name)


def test_orbax_roundtrip_sharded_restores_placements(runs):
    saved, restored, driver, kept, moments, want_moments = runs[0][0]["orbax"]
    assert driver == DRIVER and kept
    for name, value in saved.items():
        np.testing.assert_array_equal(restored[name], value, err_msg=name)
    assert moments == want_moments


def _plain_state():
    return fresh_state("resnet18", None, "adamw")


def _stepped_state():
    from ssip_tpu_torch.train.engine import epoch_plan, run_train_epoch

    state = _plain_state()
    train, _ = datasets(8, size=RESNET_IMG)
    run_train_epoch(state, train, *epoch_plan(train, seed=0, epoch=0, stream_name="o", balanced=False, batch_size=8))
    return state


def _assert_states_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, entry in sa["state"].items():
        for key, value in entry.items():
            np.testing.assert_array_equal(value.numpy(), sb["state"][i][key].numpy(), err_msg=f"{i} {key}")
    assert a.step == b.step


def test_orbax_roundtrip_unsharded(tmp_path):
    from ssip_tpu_torch.train.checkpoints import Snapshot
    from ssip_tpu_torch.train.orbax_ckpt import load_train_snapshot_orbax, save_train_snapshot_orbax

    state = _stepped_state()
    snap = tmp_path / "snap_orbax"
    save_train_snapshot_orbax(snap, Snapshot.take(state), DRIVER)
    assert snap.is_dir() and not (tmp_path / "snap_orbax.tmp").exists()
    template = _plain_state()
    snapshot, driver = load_train_snapshot_orbax(snap, template)
    snapshot.restore(template)
    assert driver == DRIVER
    _assert_states_equal(template, state)


def test_orbax_env_dispatch_and_autodetect(tmp_path, monkeypatch):
    """``save_train_snapshot`` routes by ``SSIP_SNAPSHOT_FORMAT``; a
    directory restores through DCP with the variable unset; a save cut
    between its two renames leaves the previous snapshot, found under
    ``.old``."""
    from ssip_tpu_torch.train import checkpoints

    state = _stepped_state()
    snap = tmp_path / "snap_dispatch"
    monkeypatch.setenv("SSIP_SNAPSHOT_FORMAT", "orbax")
    checkpoints.save_train_snapshot(snap, checkpoints.Snapshot.take(state), DRIVER)
    assert snap.is_dir()
    monkeypatch.delenv("SSIP_SNAPSHOT_FORMAT")
    template = _plain_state()
    snapshot, driver = checkpoints.load_train_snapshot(snap, template)
    snapshot.restore(template)
    assert driver == DRIVER
    _assert_states_equal(template, state)
    snap.rename(tmp_path / "snap_dispatch.old")  # the first rename of a save, and no second
    assert checkpoints.snapshot_exists(snap)
    assert checkpoints.load_train_snapshot(snap, _plain_state())[1] == DRIVER


def test_interrupted_training_resumes_through_orbax(tmp_path, monkeypatch):
    """The engine's resume path with the sharded form: one epoch, then a
    run to three that resumes, against three straight (rtol 1e-6)."""
    from ssip_tpu_torch.train.engine import train_model

    monkeypatch.setenv("SSIP_SNAPSHOT_FORMAT", "orbax")
    train, _ = datasets(16, size=RESNET_IMG)
    common = dict(batch_size=8, seed=42, stream_name="orbax_resume", balanced=True, augment=False,
                  early_stopping_patience=10)
    full, full_history = train_model(_plain_state(), train, train, num_epochs=3, **common)
    snap = tmp_path / "orbax_resume_snap"
    train_model(_plain_state(), train, train, num_epochs=1, resume_path=snap, **common)
    assert snap.is_dir() and (tmp_path / "orbax_resume_snap.best").is_dir()
    resumed, resumed_history = train_model(_plain_state(), train, train, num_epochs=3, resume_path=snap, **common)
    assert len(resumed_history["train_loss"]) == 3
    np.testing.assert_allclose(resumed_history["train_loss"], full_history["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(resumed.model.fc.weight.detach().numpy(), full.model.fc.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
