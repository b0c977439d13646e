"""Pytest settings of the benchmark's own tests (run them from the
repository's root: ``python -m pytest dczbench/tests -q``)."""

import tempfile

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def tmp_tmpdir(tmp_path, monkeypatch):
    """The run's files under the test's own directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    return tmp_path
