"""Port parity for deepseek-v2-236b's reduced config (the q-lora form of
MLA: ``wdq`` -> ``qnorm`` -> ``wuq``; 8 experts top-2) against the
reference package: the checks of ``test_torch_deepseek.py``, with the
tolerances stated there. Its own file, so xdist's loadfile workers share
the reference's compiles with deepseek-v2-lite-16b's.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_deepseek as ds  # noqa: E402
import test_torch_dense_archs as dense  # noqa: E402

_one_intra_op_thread = dense._one_intra_op_thread


@pytest.fixture(scope="module")
def ref():
    return ds.make_ref("deepseek-v2-236b")


@pytest.fixture(scope="module")
def ref32():
    return ds.make_ref("deepseek-v2-236b", f32=True)


def test_f32_loss_and_grad_match_reference(ref32):
    ds.check_f32_loss_and_grad_match_reference(ref32)


def test_bf16_routing_and_loss_match_reference(ref, monkeypatch):
    ds.check_bf16_routing_and_loss_match_reference(ref, monkeypatch)


def test_prefill_and_decode_match_reference(ref):
    dense.check_prefill_and_decode_past_the_ring_match_reference(ref)


def test_resident_step_matches_reference(ref32):
    dense.check_resident_step_matches_reference(ref32)


def test_registry_task_trains_on_the_cpu(ref):
    dense.check_registry_task_trains_on_the_cpu(ref)
