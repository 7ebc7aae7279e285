"""Gradients and train steps of the MoE (olmoe-1b-7b), SSM (falcon-mamba-7b)
and hybrid (zamba2-2.7b) families, reduced, the port against the JAX
package, on the CPU, at the tolerances ``test_torch_train_families.py``
states (the same run and checks, ``torch_train.run_family``).
"""
import pytest

from torch_train import check_bf16_grads, check_f32_grads, check_loss_falls, check_train_steps, run_family
from torch_train import one_thread  # noqa: F401 (autouse fixture)

FAMILIES = {"moe": "olmoe-1b-7b", "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b"}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return request.param, run_family(FAMILIES[request.param])


def test_f32_grads_equal_reference(family):
    check_f32_grads(*family)


def test_bf16_grads_equal_reference(family):
    check_bf16_grads(*family)


def test_train_steps_equal_reference(family):
    check_train_steps(*family)


def test_loss_falls_over_the_steps(family):
    check_loss_falls(*family)
