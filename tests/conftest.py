"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 real device;
only launch/dryrun.py forces 512 host devices (see system DESIGN.md §5)."""
import numpy as np
import pytest

from repro.dicom.generator import StudyGenerator


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where torch.cuda.is_available() is false"
    )


@pytest.fixture(scope="session")
def gen() -> StudyGenerator:
    return StudyGenerator(seed=1234)


@pytest.fixture()
def rng() -> np.random.Generator:
    return np.random.default_rng(0)
