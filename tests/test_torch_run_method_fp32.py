"""Port parity for the paper's FP32 baseline through ``run_method`` on the
CPU (it raised until the reference step was ported), the case of
``test_torch_run_method.py``'s ``test_unported_methods_raise`` that runs
longest, in a file of its own so xdist's loadfile workers share them.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_run_method import (_one_intra_op_thread,  # noqa: E402
                                   check_unported_method)


@pytest.mark.parametrize("args", [("fp32", "resnet18")], ids=["args0"])
def test_unported_methods_raise(args):
    check_unported_method(args)
