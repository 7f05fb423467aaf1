"""Port parity for one ResNet-18 ``reference_step`` (batch 2) against the
reference's, carried from the reference's state: the FP32 / static
baseline and dynamic precision with mixed codes on the gpu ladder (the
in-loss QDQ); and the port's QDQ gradient against its f64 evaluation. The
checks and their tolerances are ``test_torch_reference_step.py``'s (its
docstring); the tpu ladder's case and the non-finite step run in
``test_torch_reference_step_vision_tpu.py``. Files of their own, so
xdist's loadfile workers share the reference's compiles.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.train.task import VisionTask  # noqa: E402
from test_torch_reference_step import (TACS, _codes,  # noqa: E402
                                       check_vision_reference_step,
                                       vision_ref)


@pytest.mark.parametrize("case", ["static", "qdq_gpu"])
def test_vision_reference_step_matches_reference(vision_ref, case):
    check_vision_reference_step(vision_ref, case)


def test_vision_qdq_gradient_matches_f64(vision_ref):
    """Under the in-loss QDQ (codes 0/1/2 on the gpu ladder) the port's
    f32 loss gradient of ResNet-18 stays within one bf16 grid step (2^-7)
    of each leaf's largest magnitude of the same gradient evaluated in f64
    (QDQ's casts included): the bound under which the step tests
    hold the port where the reference strays."""
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    js = jax.device_get(vision_ref["state_for"](
        "qdq_gpu", _codes("qdq_gpu", vision_ref["L"], 0), 1.0))
    batch = {k: bridge.tensor(v) for k, v in
             jax.device_get(vision_ref["batch"]).items()}
    codes = torch.from_numpy(_codes("qdq_gpu", vision_ref["L"], 0))
    fn = prec.make_qdq_fn(TriAccelConfig(**TACS["qdq_gpu"]))

    def grads(dtype):
        leaves, td = tu.flatten(bridge.tree(js.params))
        wrt = [x.to(dtype).requires_grad_(True) for x in leaves]
        b = dict(batch, images=batch["images"].to(dtype))
        aux = tu.tree_map(lambda x: x.to(dtype), bridge.tree(js.aux_state))
        loss = task.loss(tu.unflatten(td, wrt), aux, b, codes, fn)[0]
        return torch.autograd.grad(loss, wrt)

    for name, a, b in zip(vision_ref["names"], grads(torch.float32),
                          grads(torch.float64)):
        gap = float((a.double() - b).abs().max())
        assert gap <= 2.0 ** -7 * float(b.abs().max()), name
