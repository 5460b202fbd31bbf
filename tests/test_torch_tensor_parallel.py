"""The model axis (``--mesh-model``): tensor and expert parallelism on four gloo ranks.

Mirrors the multichip dryrun's model-axis paths (``__graft_entry__.py``:
``resnet-tp``, ``vit-tp``, ``vit-ep`` and the FSDP composition) and
``tests/test_mesh_training.py:192-232`` with the port's own ranks, at data
2 × model 2:

- shard dims: ``tp_shard_dim`` on each torch parameter against the JAX
  ``tp_param_spec`` of its Flax leaf, for resnet18, vit_t16, vit_b16 and
  vit_moe_t16;
- one SGD step of resnet18, vit_t16 (3 heads: the qkv columns gathered),
  vit_s16 (6 heads: 3 a rank), vit_moe_t16 (4 of 8 experts a rank) and
  vit_t16 under FSDP on the data axis, on 8 rows of which 2 are padding:
  against one process at the dryrun's bound (loss 1e-4 relative, every
  parameter within 1e-3 relative norm), and against the JAX package's
  step sharded on the 8-device CPU mesh at data 2 × model 2 from the same
  weights (``tests/test_torch_parallel.py``'s bounds: loss 1e-5 relative,
  argmax equal, BatchNorm statistics 1e-5, gradients 1e-4 of each
  tensor's max);
- the leaves the model axis leaves whole get the same gradient on both
  model ranks, bit for bit (computed alike, not assumed alike), and the
  sliced ones are half their whole size on each;
- ``--resume`` on the model axis: a tiny ViT (2 heads, a head a rank)
  with AdamW cut after one of two
  epochs and resumed from a one-file snapshot and from a DCP directory
  (the whole tensors, AdamW's moments too, sliced back on restore) equals
  the uninterrupted run bit for bit; ``train_multi_seed`` refuses a model
  axis with the JAX package's message;
- the rank workers' module imports no jax;
- ``train_model`` of resnet18 with SGD for two epochs, sliced over the
  model axis, against one process at the JAX TP test's bounds (epoch 0
  rtol 1e-4, epoch 1 rtol 5e-2, metrics equal then within one flip, the
  parameters rtol 5e-2 atol 5e-4);
- both training CLIs with ``--mesh-model 2``, and the supervised one on
  vit_t16 with ``--fsdp`` too (they train with AdamW)
  against one process at the JAX package's AdamW 1-vs-N bounds
  (``test_mesh_training.py:test_adamw_metrics_equivalent_across_device_counts``:
  losses rtol 4e-2 at epoch 0 and 3e-1 at epoch 1; here the epoch-0
  decisions equal); the checkpoint is written whole and ``predict``
  reads it. AdamW's first step is about lr·sign(g), so a 1e-7 change of
  a near-zero gradient moves a weight by lr: four ranks of pure data
  parallelism already put the epoch-0 validation loss 1.2e-4 off one
  process on this tree, as the model axis does.

The ranks are spawned once; every check reads that one launch.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.parallel import mesh as jax_mesh
from ssip_tpu.ops.augment import eval_preprocess
from ssip_tpu_torch.models.host_init import arch_leaves, seeded_init_host
from ssip_tpu_torch.models.port import _torch_key, _torch_key_vit, state_dict_from_flax
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.parallel import mesh
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from tests.test_torch_data_parallel import one_process, spawn_ranks
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)
from tests.torch_model_axis_ranks import (
    CASES, MESH, cli_runs, kink_free, tp_batch, step_inputs, tp_step, tp_train_run,
)

def _variables(arch: str, size: int):
    """The seeded weights (kink-free for a ResNet) of ``tests/test_torch_parallel.py``'s
    step against JAX: seed 42, and its rows (``step_inputs(…, seed=1)``)."""
    tree = seeded_init_host(arch, 42, 2, image_size=size)
    return kink_free(tree) if arch.startswith("resnet") else tree


def jax_sharded_step(arch: str, variables, inputs, fsdp: bool):
    """The JAX step's loss and gradients (``engine.py:_step_core``'s loss:
    the masked cross-entropy and every sown auxiliary term) on the CPU mesh
    at data 2 × model 2, the weights placed by ``tree_shardings`` and the
    rows over the data axis, XLA partitioning the program: (loss, argmax,
    gradients, BatchNorm statistics after), torch-named."""
    images, labels, valid = inputs
    model = MODEL_FACTORIES[arch](num_classes=2)
    cpu_mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=MESH[0], model=MESH[1]), devices=jax.devices()[:4])

    @jax.jit
    def loss_and_grad(params, batch_stats, images_u8, labels, valid):
        def loss_fn(params):
            logits, new_state = model.apply({"params": params, "batch_stats": batch_stats}, eval_preprocess(images_u8),
                                            train=True, mask=valid, mutable=["batch_stats", "aux"])
            w = valid.astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            loss = jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)
            for term in jax.tree.leaves(dict(new_state).get("aux", {})):
                loss = loss + jnp.sum(term)
            return loss, (logits, new_state)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    rows = NamedSharding(cpu_mesh, P("data"))
    params = jax.device_put(variables["params"], jax_mesh.tree_shardings(cpu_mesh, variables["params"], fsdp=fsdp))
    stats = variables.get("batch_stats", {})
    with cpu_mesh:
        (loss, (logits, new_state)), grads = loss_and_grad(
            params, jax.device_put(stats, NamedSharding(cpu_mesh, P())), jax.device_put(images, rows),
            jax.device_put(labels.astype(np.int32), rows), jax.device_put(valid, rows))
    new_stats = jax.device_get(dict(new_state).get("batch_stats", {}))
    return (float(loss), np.asarray(jnp.argmax(logits, axis=1)), state_dict_from_flax({"params": jax.device_get(grads)}),
            state_dict_from_flax({"batch_stats": new_stats}) if new_stats else {})


def reference(variables, inputs, tree, out_dir):
    """In this process: one process's step of each case, the JAX sharded
    steps, and the two CLIs."""
    one = {case: one_process(tp_step, arch, variables[case], inputs[case], None)
           for case, (arch, _, _) in CASES.items()}
    jax_steps = {case: jax_sharded_step(arch, variables[case], inputs[case], fsdp)
                 for case, (arch, _, fsdp) in CASES.items()}
    one["trajectory"] = one_process(tp_train_run, None)
    return one, jax_steps, one_process(cli_runs, tree, out_dir)


def image_tree(root):
    """The labeled 6 + 6 and unlabeled 10 image 64² JPEG tree of
    ``tests/conftest.py:tiny_image_tree``."""
    from PIL import Image

    gen = np.random.default_rng(0)
    for bucket in ("cancer", "normal"):
        (root / "avec_labels" / bucket).mkdir(parents=True)
        for i in range(6):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
                root / "avec_labels" / bucket / f"{bucket}_{i:02d}.jpg")
    (root / "sans_label").mkdir()
    for i in range(10):
        Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            root / "sans_label" / f"unlabeled_{i:02d}.jpg")
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    tiny_image_tree = image_tree(out / "data")
    variables = {case: _variables(arch, size) for case, (arch, size, _) in CASES.items()}
    inputs = {case: step_inputs(size, seed=1) for case, (_, size, _) in CASES.items()}
    ranks, (one, jax_steps, cli_one) = spawn_ranks(
        tp_batch, (variables, inputs, str(tiny_image_tree), str(out)), out, world=4,
        meanwhile=lambda: reference(variables, inputs, str(tiny_image_tree), str(out)))
    return ranks, one, jax_steps, cli_one, tiny_image_tree


class _Leaf:
    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


@pytest.mark.parametrize("arch", ["resnet18", "vit_t16", "vit_b16", "vit_moe_t16"])
@pytest.mark.parametrize("model_par", [2, 4])
def test_shard_dims_match_jax_leaf_for_leaf(arch, model_par):
    params = {k: tuple(p.shape) for k, p in build_model(arch, num_classes=2).named_parameters()}
    to_key = _torch_key if arch.startswith("resnet") else _torch_key_vit
    seen, sliced = set(), 0
    for path, shape in arch_leaves(arch, num_classes=2):
        if path[0] != "params":
            continue
        key = to_key(path[1:])
        spec = jax_mesh.tp_param_spec(tuple(jax.tree_util.DictKey(n) for n in path[1:]), _Leaf(shape), model_par)
        entries = list(spec)
        perm = mesh.torch_layout(key, params[key])
        want = perm[entries.index("model")] if "model" in entries else None
        assert mesh.tp_shard_dim(key, params[key], model_par) == want, key
        seen.add(key)
        sliced += want is not None
    assert seen == set(params) and sliced > 0


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_one_process(runs, case):
    """The dryrun's bar: loss within 1e-4 relative, every parameter (and
    BatchNorm statistic) after the step within 1e-3 relative norm; the
    argmax equal."""
    ranks, one = runs[0], runs[1]
    loss, preds, _, state, _ = ranks[0][case]
    loss1, preds1, _, state1, _ = one[case]
    assert abs(loss - loss1) <= 1e-4 * abs(loss1)
    np.testing.assert_array_equal(preds, preds1)
    assert set(state) == set(state1)
    for name, value in state1.items():
        if value.dtype.kind == "f":
            rel = np.linalg.norm(state[name] - value) / max(np.linalg.norm(value), 1e-12)
            assert rel < 1e-3, (name, rel)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_sharded_step(runs, case):
    ranks, jax_steps = runs[0], runs[2]
    loss, preds, grads, state, _ = ranks[0][case]
    loss_j, preds_j, grads_j, stats_j = jax_steps[case]
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(preds, preds_j)
    for name, value in stats_j.items():
        rel = np.abs(state[name] - value).max() / max(np.abs(value).max(), 1e-30)
        assert rel <= 1e-5, (name, rel)
    assert set(grads) == set(grads_j)
    for name, g in grads_j.items():
        rel = np.abs(grads[name] - g).max() / max(np.abs(g).max(), 1e-30)
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("case", [c for c, (_, _, fsdp) in CASES.items() if not fsdp])
def test_model_ranks_agree(runs, case):
    """Ranks 0 and 1 (and 2 and 3) are one data rank's two model ranks:
    the leaves the axis leaves whole get bit-for-bit the same gradient on
    both, and every rank ends with the same whole state."""
    ranks = runs[0]
    for a, b in ((0, 1), (2, 3)):
        repl_a, repl_b = ranks[a][case][4], ranks[b][case][4]
        assert repl_a and set(repl_a) == set(repl_b)
        for name, g in repl_a.items():
            np.testing.assert_array_equal(g, repl_b[name], err_msg=name)
    for r in ranks[1:]:
        for name, value in ranks[0][case][3].items():
            np.testing.assert_array_equal(value, r[case][3][name], err_msg=name)
    sliced = set(ranks[0][case][2]) - set(ranks[0][case][4])
    assert sliced, "the model axis sliced nothing"


def _history(out_dir):
    return json.loads(ArtifactRegistry(Path(out_dir)).training_history_json.read_text())


def _assert_history(got, want, rtols, decisions_atol):
    for key in ("train_loss", "val_loss"):
        for epoch, rtol in enumerate(rtols[: len(want[key])]):
            np.testing.assert_allclose(got[key][epoch], want[key][epoch], rtol=rtol, err_msg=f"{key}[{epoch}]")
    for key in ("train_acc", "val_acc", "train_f1", "val_f1"):
        np.testing.assert_allclose(got[key][0], want[key][0], err_msg=f"{key}[0]")
        if len(want[key]) > 1:
            np.testing.assert_allclose(got[key][1], want[key][1], atol=decisions_atol, err_msg=f"{key}[1]")


def test_trajectory_matches_one_process(runs):
    """``test_mesh_training.py:test_tensor_parallel_trajectory_matches_single_device``."""
    (got, state), (want, state1) = runs[0][0]["trajectory"], runs[1]["trajectory"]
    _assert_history(got, want, (1e-4, 5e-2), 1 / 8 + 1e-9)
    for name, value in state1.items():
        np.testing.assert_allclose(state[name], value, rtol=5e-2, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("cli", ["supervised", "semi", "fsdp"])
def test_cli_mesh_model_matches_one_process(runs, cli, capsys):
    """``--mesh-model 2`` on four ranks against one process, each stream
    at the JAX AdamW bound; the checkpoint whole, of the one-process
    shapes and within rtol 5e-2, atol 5e-4; ``predict`` reads the ranks'
    run."""
    from ssip_tpu_torch.cli import predict

    ranks, cli_one, tree = runs[0], runs[3], runs[4]
    got_dir, want_dir = ranks[0]["cli"][cli], cli_one[cli]
    got, want = _history(got_dir), _history(want_dir)
    for stream in ("baseline", "semi_pretrain", "semi_finetune") if cli == "semi" else ("baseline",):
        _assert_history(got[stream], want[stream], (4e-2, 3e-1), 1 / 8 + 1e-9)
    model = "semi" if cli == "semi" else "baseline"
    ckpt, ckpt1 = (torch.load(getattr(ArtifactRegistry(Path(d)), f"{model}_checkpoint"), weights_only=True)
                   for d in (got_dir, want_dir))
    assert {k: tuple(v.shape) for k, v in ckpt.items()} == {k: tuple(v.shape) for k, v in ckpt1.items()}
    for name, value in ckpt1.items():
        if value.is_floating_point():
            np.testing.assert_allclose(ckpt[name].numpy(), value.numpy(), rtol=5e-2, atol=5e-4, err_msg=name)
    capsys.readouterr()
    predict.main(["--images", str(tree / "sans_label"), "--model", model, "--output-dir", got_dir,
                  "--device", "cpu"])
    rows = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(rows) == 1 + 10  # the header and one row an image


@pytest.mark.parametrize("form", ["file", "orbax"])
def test_resume_on_the_model_axis_is_bitwise(runs, form):
    for rank in runs[0]:
        (straight, state), (resumed, state_r) = rank["resume"][form]
        assert straight == resumed
        assert set(state) == set(state_r)
        for name, value in state.items():
            np.testing.assert_array_equal(state_r[name], value, err_msg=name)


def test_seed_fan_out_refuses_a_model_axis():
    from ssip_tpu_torch.train.multi_seed import train_multi_seed

    class _Mesh:  # data 1 × model 2, as the JAX guard reads it
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (1, 2)[dim]

    with pytest.raises(ValueError, match="not combinable with num_seeds > 1"):
        train_multi_seed([None, None], None, None, seeds=[1, 2], num_epochs=1, batch_size=4, stream_name="s",
                         mesh=_Mesh())


def test_rank_workers_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, tests.torch_model_axis_ranks\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'ssip_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])

