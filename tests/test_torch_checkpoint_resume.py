"""Port parity for resuming through ``run_method``: a ResNet-18 run with a
checkpoint directory reports where it resumed (the bitwise resume of the
``Trainer`` runs in ``test_torch_checkpoint_preempt.py``). The checks are
stated in ``test_torch_checkpoint.py``'s docstring.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.train import paper_harness  # noqa: E402
from test_torch_checkpoint import _one_intra_op_thread  # noqa: E402, F401


# ---------------------------------------------------------------- resume --
def test_run_method_reports_resumed_from(tmp_path):
    tr = paper_harness.make_trainer("triaccel", "resnet18", steps=2,
                                    batch0=4, ckpt_dir=str(tmp_path),
                                    device="cpu")[0]
    assert tr.tcfg.ckpt_every == 10
    tr.run(1)
    res = paper_harness.run_method("triaccel", "resnet18", steps=2, batch0=4,
                                   ckpt_dir=str(tmp_path), device="cpu")
    assert res.resumed_from == 1 and len(res.log) == 1
    assert res.log[0]["step"] == 1 and res.eff_score > 0
    assert ck.latest_step(str(tmp_path)) == 2
