"""Port parity for gemma3-4b at its reduced config against the reference:
the checks of ``test_torch_dense_archs.py``, which states them and their
tolerances (the decode wraps the local layers' 8-slot ring caches), and
the flash path at S 256 through the reference's Pallas kernels in
interpret mode. A file of its own, so that xdist's loadfile workers share
the reference's compiles.
"""
import pytest

pytest.importorskip("torch")

from test_torch_dense_archs import (  # noqa: E402, F401 (a fixture)
    check_loss_and_grad_match_reference,
    check_prefill_and_decode_past_the_ring_match_reference,
    check_registry_task_trains_on_the_cpu,
    _one_intra_op_thread, check_gemma3_flash_path,
    check_resident_step_matches_reference, make_ref)


@pytest.fixture(scope="module")
def ref():
    return make_ref("gemma3-4b")


def test_loss_and_grad_match_reference(ref):
    check_loss_and_grad_match_reference(ref)


def test_prefill_and_decode_match_reference(ref):
    check_prefill_and_decode_past_the_ring_match_reference(ref)


def test_resident_step_matches_reference(ref):
    check_resident_step_matches_reference(ref)


def test_registry_task_trains_on_the_cpu(ref):
    check_registry_task_trains_on_the_cpu(ref)


def test_flash_path_matches_reference():
    """The reduced widths at S 256 through the attention kernels: the
    reference's Pallas kernels (interpret mode), the port's plain
    versions, the local layers on the kernels' static window."""
    check_gemma3_flash_path()
