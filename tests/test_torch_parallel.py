"""The port's ``parallel/`` against the JAX package's, and the two-rank
paths held to the JAX single-device functions.

- ``fsdp_param_spec`` and ``tp_param_spec`` leaf for leaf against the JAX
  functions on the ``resnet18``, ``vit_b16`` and ``vit_moe_s16`` trees, at
  data 2, 4 and 8 and model 1 and 2, and ``fsdp_shard_dim`` on each torch
  parameter against the JAX spec of its Flax leaf;
- ``pad_to_multiple``, ``shard_batch``; ``initialize()``'s no-op and
  warning cases (``tests/test_distributed.py``) and a two-process join in
  both launch forms (the ``SSIP_*`` variables, torchrun's);
- a ResNet step on two gloo ranks against the JAX step
  (``tests/test_torch_train.py``'s bounds: loss 1e-5 relative, argmax
  equal, BatchNorm statistics 1e-5, gradients 1e-4 of each tensor's max,
  parameters 1e-6 where the gradient is not near zero);
- the pool's probabilities on two ranks against the JAX function (atol
  1e-6, ``tests/test_mesh_training.py``);
- (``--shard-size`` is ``tests/test_torch_sharded_extraction.py``.)
"""

from __future__ import annotations

import functools
import json
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from ssip_tpu.models import ResNet18
from ssip_tpu.parallel import mesh as jax_mesh
from ssip_tpu.train.pseudo_label import pool_probabilities as jax_pool_probabilities
from ssip_tpu_torch.models.host_init import arch_leaves, seeded_init_host
from ssip_tpu_torch.models.port import _torch_key, _torch_key_vit
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.parallel import distributed, mesh
from tests.test_torch_data_parallel import pool_on_ranks, spawn_ranks, step_on_ranks
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)
from tests.test_torch_train import _jax_step, _kink_free, _rel, _step_inputs

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("resnet18", "vit_b16", "vit_moe_s16")


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)
        self.size = int(np.prod(shape))


def _canonical(spec: PartitionSpec) -> tuple:
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _jax_path(names):
    return tuple(jax.tree_util.DictKey(n) for n in names)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data", [2, 4, 8])
@pytest.mark.parametrize("model", [1, 2])
def test_specs_match_jax_leaf_for_leaf(arch, data, model):
    leaves = list(arch_leaves(arch, num_classes=2))
    sharded = 0
    for path, shape in leaves:
        names = path[1:]  # below the collection, as the rules read it
        want_fsdp = _canonical(jax_mesh.fsdp_param_spec(_jax_path(names), _Leaf(shape), data, model))
        assert mesh.fsdp_param_spec(names, shape, data, model) == want_fsdp, path
        want_tp = _canonical(jax_mesh.tp_param_spec(_jax_path(names), _Leaf(shape), model))
        assert mesh.tp_param_spec(names, shape, model) == want_tp, path
        sharded += mesh.DATA_AXIS in want_fsdp
    assert sharded > 0


@functools.lru_cache(maxsize=None)
def _torch_shapes(arch: str) -> dict:
    return {k: tuple(p.shape) for k, p in build_model(arch, num_classes=2).named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data", [2, 4, 8])
def test_torch_shard_dims_follow_the_jax_spec(arch, data):
    """The dimension ``--fsdp`` shards of each torch parameter is its Flax
    leaf's data-axis dimension, carried through the layout change."""
    params = _torch_shapes(arch)
    to_key = _torch_key if arch.startswith("resnet") else _torch_key_vit
    seen = set()
    for path, shape in arch_leaves(arch, num_classes=2):
        if path[0] != "params":
            continue
        key = to_key(path[1:])
        spec = _canonical(jax_mesh.fsdp_param_spec(_jax_path(path[1:]), _Leaf(shape), data, 1))
        perm = mesh.torch_layout(key, params[key])
        assert tuple(params[key][p] for p in perm) == tuple(shape), key
        want = perm[spec.index("data")] if "data" in spec else None
        assert mesh.fsdp_shard_dim(key, params[key], data) == want, key
        seen.add(key)
    assert seen == set(params)


@pytest.mark.parametrize("n,multiple,want", [(5, 2, 6), (8, 4, 8), (1, 8, 8), (0, 3, 0)])
def test_pad_to_multiple_matches_jax(n, multiple, want):
    assert mesh.pad_to_multiple(n, multiple) == jax_mesh.pad_to_multiple(n, multiple) == want
    with pytest.raises(ValueError):
        mesh.pad_to_multiple(n, 0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_shard_batch_without_a_group_is_the_whole_batch(kind):
    array = np.arange(15).reshape(5, 3)
    batch = torch.from_numpy(array) if kind == "torch" else array
    rows, n = mesh.shard_batch(None, batch)
    assert n == 5 and np.array_equal(np.asarray(rows), array)
    assert mesh.local_rows(None, 5) == slice(0, 5)
    assert mesh.training_mesh() is None
    with pytest.raises(RuntimeError, match="needs that many processes"):
        mesh.training_mesh(data=2)


def test_initialize_noop_without_config(monkeypatch):
    for var in ("SSIP_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}


def test_initialize_noop_single_process_warns(monkeypatch, caplog):
    monkeypatch.setenv("SSIP_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("SSIP_NUM_PROCESSES", "1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with caplog.at_level(logging.WARNING):
        assert distributed.initialize() is False
    assert "SSIP_NUM_PROCESSES is 1" in caplog.text
    monkeypatch.delenv("SSIP_NUM_PROCESSES")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert distributed.initialize() is False
    assert "SSIP_NUM_PROCESSES is unset" in caplog.text


@pytest.mark.parametrize("form", ["ssip", "torchrun"])
def test_two_process_group_joins(tmp_path, form):
    """Two local processes join one gloo group through ``initialize()``:
    the ``SSIP_*`` variables (a ``file://`` coordinator) or torchrun's
    (``tcp://localhost``); each sees both."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = (
        "import json\n"
        "from ssip_tpu_torch.parallel.distributed import initialize, process_info, shutdown\n"
        "ok = initialize(device='cpu')\n"
        "print('RESULT ' + json.dumps({'ok': ok, **process_info()}))\n"
        "shutdown()\n"
    )
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")}
        if form == "ssip":
            env.update(SSIP_COORDINATOR=f"file://{tmp_path / 'init'}", SSIP_NUM_PROCESSES="2", SSIP_PROCESS_ID=str(pid))
        else:
            env.update(RANK=str(pid), WORLD_SIZE="2", LOCAL_RANK=str(pid), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        env["PYTHONPATH"] = str(REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", worker], env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        results.append(json.loads([line for line in out.splitlines() if line.startswith("RESULT ")][-1][7:]))
    assert all(r["ok"] and r["process_count"] == r["global_devices"] == 2 for r in results)
    assert {r["process_index"] for r in results} == {0, 1}


def test_a_crashed_rank_leaves_at_once_and_its_peer_does_not_hang(tmp_path):
    """Two ranks join through ``initialize(device='cpu')`` inside the
    training CLI's ``run_distributed``; rank 1's pipeline raises, rank 0's
    returns. Rank 1 leaves without the barrier, so its stderr ends in its
    own exception; rank 0 leaves through the barrier, which may raise now
    that its peer is gone, but both exit well inside the time limit."""
    worker = (
        "from ssip_tpu_torch.cli.supervised_training import run_distributed\n"
        "from ssip_tpu_torch.parallel import distributed\n"
        "from ssip_tpu_torch.pipelines.train_config import TrainingConfig\n"
        "def pipeline(config):\n"
        "    if distributed.rank() == 1:\n"
        "        raise RuntimeError('rank 1 fails on purpose')\n"
        "    return 'done'\n"
        "print('RESULT ' + run_distributed(TrainingConfig(strong_data_dir='.', device='cpu'), pipeline))\n"
    )
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")}
        env.update(SSIP_COORDINATOR=f"file://{tmp_path / 'init'}", SSIP_NUM_PROCESSES="2", SSIP_PROCESS_ID=str(pid),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", worker], env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    t0 = time.monotonic()
    (out0, err0), (out1, err1) = (p.communicate(timeout=120) for p in procs)
    assert time.monotonic() - t0 < 60
    assert procs[1].returncode != 0 and "RESULT" not in out1
    # torch prefixes a rank's traceback lines with "[rank1]: "
    assert err1.strip().splitlines()[-1].endswith("RuntimeError: rank 1 fails on purpose"), err1[-2000:]
    assert procs[0].returncode is not None
    if procs[0].returncode == 0:
        assert "RESULT done" in out0


class _FakeDist:
    """``torch.distributed`` as ``shutdown`` sees it: a joined group on
    ``backend``, every call recorded; ``barrier_error`` makes the barrier
    raise, as it does when a peer is gone."""

    def __init__(self, backend: str, barrier_error=None):
        self.backend, self.barrier_error, self.calls = backend, barrier_error, []

    def is_available(self):
        return True

    def is_initialized(self):
        return ("destroy", {}) not in self.calls

    def get_backend(self):
        return self.backend

    def barrier(self, **kwargs):
        self.calls.append(("barrier", kwargs))
        if self.barrier_error is not None:
            raise self.barrier_error

    def destroy_process_group(self):
        self.calls.append(("destroy", {}))


@pytest.mark.parametrize("clean,backend,want", [
    (True, "gloo", [("barrier", {}), ("destroy", {})]),
    (True, "nccl", [("barrier", {"device_ids": [3]}), ("destroy", {})]),
    (False, "gloo", [("destroy", {})]),
    (False, "nccl", [("destroy", {})]),
])
def test_shutdown_passes_the_barrier_only_on_the_clean_path(monkeypatch, clean, backend, want):
    fake = _FakeDist(backend)
    monkeypatch.setattr(distributed, "dist", fake)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    distributed.shutdown(clean=clean)
    assert fake.calls == want
    distributed.shutdown(clean=clean)  # the group is gone: nothing more
    assert fake.calls == want


def test_shutdown_destroys_the_group_when_the_barrier_raises(monkeypatch):
    fake = _FakeDist("gloo", barrier_error=RuntimeError("Connection closed by peer"))
    monkeypatch.setattr(distributed, "dist", fake)
    with pytest.raises(RuntimeError, match="closed by peer"):
        distributed.shutdown(clean=True)
    assert fake.calls == [("barrier", {}), ("destroy", {})]


def _record_shutdowns(monkeypatch, module) -> list:
    calls = []
    monkeypatch.setattr(module.distributed, "initialize", lambda **kwargs: True)
    monkeypatch.setattr(module.distributed, "shutdown", lambda clean=True: calls.append(clean))
    return calls


@pytest.mark.parametrize("fails", [False, True])
def test_run_distributed_says_which_path_it_leaves_on(monkeypatch, fails):
    from ssip_tpu_torch.cli import supervised_training
    from ssip_tpu_torch.pipelines.train_config import TrainingConfig

    calls = _record_shutdowns(monkeypatch, supervised_training)

    def pipeline(config):
        if fails:
            raise ValueError("the pipeline's own error")
        return "result"

    config = TrainingConfig(strong_data_dir=Path("."), device="cpu")
    if fails:
        with pytest.raises(ValueError, match="the pipeline's own error"):
            supervised_training.run_distributed(config, pipeline)
    else:
        assert supervised_training.run_distributed(config, pipeline) == "result"
    assert calls == [not fails]


@pytest.mark.parametrize("fails", [False, True])
def test_extraction_cli_says_which_path_it_leaves_on(monkeypatch, capsys, fails):
    from types import SimpleNamespace

    from ssip_tpu_torch.cli import feature_extraction

    calls = _record_shutdowns(monkeypatch, feature_extraction)

    def extract(cfg):
        if fails:
            raise OSError("the extraction's own error")
        return SimpleNamespace(embeddings=np.zeros((3, 512)), total_seconds=1.0)

    monkeypatch.setattr(feature_extraction, "run_extraction", extract)
    if fails:
        with pytest.raises(OSError, match="the extraction's own error"):
            feature_extraction.main(["--device", "cpu"])
    else:
        feature_extraction.main(["--device", "cpu"])
        assert "Extracted 3 embeddings (512-D)" in capsys.readouterr().out
    assert calls == [not fails]


@pytest.mark.parametrize("augment,seed", [(True, 1), (False, 1)])
def test_two_rank_step_matches_jax(augment, seed, tmp_path):
    """8 rows, 2 of them padding, split 4 + 4 over two ranks (the second's
    last two are the padding): the global loss, the gathered predictions,
    the summed gradients and the state after AdamW against the JAX
    single-device step, at ``test_torch_train.py``'s bounds."""
    from ssip_tpu_torch.models.port import state_dict_from_flax

    images, labels, valid, key, coeffs = _step_inputs(seed, augment)
    variables = _kink_free(seeded_init_host("resnet18", 42, 2))
    loss_j, pred_j, grads_j, stats_j, params_j = _jax_step(variables, images, labels, valid, key, augment)
    ranks = spawn_ranks(step_on_ranks, (variables, images, labels, valid, coeffs), tmp_path)
    loss_t, pred_t, grads_t, sd = ranks[0]
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    for name, value in state_dict_from_flax({"batch_stats": jax.device_get(stats_j)}).items():
        assert _rel(sd[name], value) <= 1e-5, name
    want_grads = state_dict_from_flax({"params": jax.device_get(grads_j)})
    want_params = state_dict_from_flax({"params": jax.device_get(params_j)})
    for name, g in want_grads.items():
        assert _rel(grads_t[name], g) <= 1e-4, name
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(sd[name][big], want_params[name][big], rtol=0, atol=1e-6, err_msg=name)
    for name, value in sd.items():
        np.testing.assert_array_equal(value, ranks[1][3][name], err_msg=name)


def test_two_rank_pool_probabilities_match_jax(tmp_path):
    """13 images in batches of 5 (each padded to 6 and split 3 + 3): the
    JAX function's probabilities, atol 1e-6, in pool order on both ranks."""
    variables = seeded_init_host("resnet18", 3, 2)
    pool = np.random.default_rng(4).integers(0, 255, (13, 32, 32, 3), dtype=np.uint8)
    want = jax_pool_probabilities(ResNet18(num_classes=2).apply, variables, jax.numpy.asarray(pool), batch_size=5)
    ranks = spawn_ranks(pool_on_ranks, (variables, pool, 5), tmp_path)
    for got in ranks:
        assert got.shape == want.shape == (13, 2)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
