"""``--device`` resolution of the PyTorch port: ``auto`` (every CLI's and
config's default) means the card, and only an explicit ``cpu`` runs on the
CPU. The card's presence is set by ``monkeypatch``, so these run the same
with and without one."""

import pytest
import torch

from ssip_tpu_torch.cli import supervised_training as supervised_cli
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.runtime.device import resolve_device


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture()
def a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("name", ["auto", "AUTO", "", None, "cuda", "cuda:1"])
def test_card_names_raise_without_a_card_and_name_the_cpu_flag(no_card, name):
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(name)


@pytest.mark.parametrize("name", ["cpu", "CPU"])
def test_explicit_cpu_runs_on_the_cpu(no_card, name):
    assert resolve_device(name) == torch.device("cpu")


@pytest.mark.parametrize(
    "name,want", [("auto", "cuda"), (None, "cuda"), ("cuda", "cuda"), ("cuda:1", "cuda:1"), ("cpu", "cpu")]
)
def test_with_a_card_auto_is_the_card(a_card, name, want):
    assert resolve_device(name) == torch.device(want)


@pytest.mark.parametrize("name", ["tpu", "gpu", "cuda0", "mps"])
def test_bad_name_raises_value_error(no_card, name):
    with pytest.raises(ValueError, match="auto\\|cpu\\|cuda"):
        resolve_device(name)


def test_default_config_and_cli_refuse_to_fall_back_to_the_cpu(no_card, tmp_path):
    """The defaults stay ``"auto"`` (as the JAX package's), and a run built
    on them raises before it reads any data."""
    assert TrainingConfig(strong_data_dir=tmp_path).device == "auto"
    with pytest.raises(RuntimeError, match="--device cpu"):
        supervised_cli.main(["--strong-data-dir", str(tmp_path / "missing")])
