"""Fixtures of the benchmark's CPU tests (``tiny.py``)."""

import pytest

from tiny import make_tiny


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path)
