"""Gradients and train steps of every model family, the port against the JAX
package, on the CPU: dense (qwen2-0.5b), sliding window (h2o-danube-1.8b),
VLM (llava-next-34b) and encoder (hubert-xlarge), each reduced; MoE, SSM
and hybrid are in ``test_torch_train_families_moe_ssm.py``.

Both start from the reference's ``train_state_init`` (carried across with
``carry.train_state_from_numpy``) and take the same batches from numpy
seeds. Tolerances, set beforehand:

* gradients of the loss with the weights in f32 (the reduced configs
  compute in f32, so the values are the same as with the bf16 weights; the
  gradients skip bf16's rounding): ``jax.grad`` against the port's
  ``.grad`` within 1e-4 relative per leaf (||port - ref|| / ||ref||);
* the bf16 weights' own gradients (what a train step uses) within 1e-3
  relative per leaf: both round their f32 cotangents to bf16 and sum the
  embedding rows of repeated tokens in bf16, so a difference of 1e-7 in
  f32 can become one bf16 ulp (4e-3) of a row;
* 3 train steps from the same state: losses within 1e-4 (atol and rtol);
  gnorm within 1e-3 relative (the reference's own jitted step keeps excess
  precision where its gradients are rounded to bf16: on falcon-mamba its
  step-0 gnorm is 1.7e-4 from the norm of its own ``jax.grad``); master
  weights as ``torch_train.assert_master_close`` says. The run and the
checks are ``torch_train.run_family`` and ``check_*``.
"""
import pytest

from torch_train import check_bf16_grads, check_f32_grads, check_loss_falls, check_train_steps, run_family
from torch_train import one_thread  # noqa: F401 (autouse fixture)

FAMILIES = {"dense": "qwen2-0.5b", "sliding_window": "h2o-danube-1.8b", "vlm": "llava-next-34b",
            "encoder": "hubert-xlarge"}


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
