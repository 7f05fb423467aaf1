"""Port parity for ResNet-18's ``reference_step`` on the tpu ladder (mixed
codes, fp8 on the stem, the in-loss QDQ) and for a non-finite step (loss
scale inf: params, moments and aux state kept bitwise), against the
reference's. The checks and their tolerances are
``test_torch_reference_step.py``'s (its docstring); the other vision
cases run in ``test_torch_reference_step_vision.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_reference_step import (check_vision_reference_step,  # noqa
                                       vision_ref)


@pytest.mark.parametrize("case", ["qdq_tpu", "nonfinite"])
def test_vision_reference_step_matches_reference(vision_ref, case):
    check_vision_reference_step(vision_ref, case)
