"""Port parity for the harness's entry points on the CPU: a short
``run_method`` of the Tri-Accel method, the device contract (cuda without a
card raises, nothing falls back), and the methods that raised until they
were ported (EfficientNet-B0 here, the FP32 baseline in
``test_torch_run_method_fp32.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.train import paper_harness  # noqa: E402
from repro_torch.train.task import VisionTask  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401


def test_run_method_smoke_on_cpu():
    res = paper_harness.run_method("triaccel", "resnet18", steps=3,
                                   batch0=4, device="cpu")
    assert len(res.log) == 3
    assert all(np.isfinite(m["loss"]) for m in res.log)
    assert res.final_batch in (2, 4, 6, 8)
    assert len(res.codes) == 11 and set(res.codes) <= {0, 1, 2}
    assert 0.0 <= res.accuracy <= 100.0
    assert res.measured_bytes == {}          # the analytic model answers


def test_entry_points_need_a_card_for_cuda(monkeypatch):
    """Asking for cuda without a card raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VisionConfig("resnet18")
    with pytest.raises(RuntimeError, match="is_available"):
        VisionTask(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        paper_harness.run_method("triaccel", "resnet18", steps=1,
                                 device="cuda")


# the parametrized cases keep their ids across the two files
@pytest.mark.parametrize("args", [("triaccel", "efficientnet_b0")],
                         ids=["args1"])
def test_unported_methods_raise(args):
    check_unported_method(args)


def check_unported_method(args):
    """Both raised here until they were ported. The FP32 baseline now
    runs on the CPU, on the reference path over tree-form state, at the
    fixed rung, with the codes reported as fp32. EfficientNet-B0 now
    trains on the resident fused path over its 21 layers (7,936 slab
    rows); ``tests/test_torch_vision_effnet.py`` runs its ``run_method``
    end to end."""
    if args[0] != "fp32":
        trainer = paper_harness.make_trainer(*args, steps=1, batch0=4,
                                             device="cpu")[0]
        assert trainer.fused and trainer.resident
        assert (trainer.view.rows, trainer.view.num_layers) == (7936, 21)
        log = trainer.run(1)
        assert len(log) == 1 and np.isfinite(log[0]["loss"])
        assert trainer.state.control.codes.shape == (21,)
        return
    trainer = paper_harness.make_trainer(*args, steps=2, batch0=4,
                                         device="cpu")[0]
    assert not trainer.fused and not trainer.resident
    assert trainer.params_tree() is trainer.state.params
    res = paper_harness.run_method(*args, steps=2, batch0=4, device="cpu")
    assert len(res.log) == 2
    assert all(np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
               for m in res.log)
    assert res.codes == [2] * 11
    assert res.final_batch == 4 and res.batch_history == []
    assert 0.0 <= res.accuracy <= 100.0
