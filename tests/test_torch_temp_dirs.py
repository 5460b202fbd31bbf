"""Temp-dir hygiene of the port's test files.

pytest keeps the temp dirs of its last three runs, and the port's tests
write full-width checkpoints and resume snapshots (134 MB each for a
``resnet18``), so one run once left 6.7 GB behind. Each test file that
writes such files takes ``remove_temp_dirs`` (``from
tests.test_torch_temp_dirs import remove_temp_dirs``): at the module's end
it removes what the module's tests and fixtures made under pytest's temp
dir, and nothing that was there before.
"""

import shutil
from pathlib import Path

import pytest


def new_entries_removed(base: Path):
    """Note ``base``'s entries, yield, then remove every entry made since
    (dirs with their contents, and files and links)."""
    before = set(base.iterdir())
    yield
    for path in set(base.iterdir()) - before:
        if path.is_dir() and not path.is_symlink():
            shutil.rmtree(path, ignore_errors=True)
        else:
            path.unlink(missing_ok=True)


@pytest.fixture(scope="module", autouse=True)
def remove_temp_dirs(tmp_path_factory):
    """At the module's end, remove the temp dirs its tests and fixtures made."""
    yield from new_entries_removed(tmp_path_factory.getbasetemp())


def test_new_entries_removed_keeps_what_was_there(tmp_path):
    (tmp_path / "kept").mkdir()
    (tmp_path / "kept" / "a.bin").write_bytes(b"x")
    steps = new_entries_removed(tmp_path)
    next(steps)
    (tmp_path / "made" / "deep").mkdir(parents=True)
    (tmp_path / "made" / "deep" / "snap.torchsnap").write_bytes(b"y" * 10)
    (tmp_path / "made.txt").write_text("z")
    (tmp_path / "madecurrent").symlink_to(tmp_path / "made")
    with pytest.raises(StopIteration):
        next(steps)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["kept"]
    assert (tmp_path / "kept" / "a.bin").read_bytes() == b"x"
