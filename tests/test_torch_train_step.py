"""Port parity: one slab-resident train step of ResNet-18 (batch 2) from a
shared state, carried from the reference into the port through
``repro_torch.bridge`` — all-bf16 codes, mixed 0/1/2 codes, and a
non-finite step (loss scale inf, so the update is skipped) — then a short
``run_method`` on the CPU and the device contract of the entry points.

Tolerances, all measured against the reference's own numbers:
  * loss within rtol 1e-5; BatchNorm running stats within rtol 1e-5;
  * the momentum slab (after one step from zero momentum: the clipped,
    unscaled gradient plus weight decay) leaf by leaf within 2e-4 of the
    leaf's largest magnitude, 3e-2 in the stem and the first residual
    block, where the reference's XLA-CPU convolution gradient itself strays
    from an f64 evaluation by up to 1.7e-2 (``test_torch_vision``);
  * the master: p_new - p_ref = -lr * (m_new - m_ref) up to two f32
    roundings, 2^-21 * (|p| + |p_new|);
  * the next compute copy within one grid step of its tier (2^-7 relative,
    or one f16 subnormal step, 2^-24) and its per-layer absmax likewise;
  * codes, step and loss scale equal; var_ema within rtol 5e-2 in the
    layers the stem gradient feeds, 1e-3 elsewhere;
  * the skipped step: master, momentum, BN state and the copy bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.controller import init_control as jinit_control  # noqa
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.data.synthetic import CIFARLikeStream as JStream  # noqa: E402
from repro.kernels.layout import slab_view as jslab_view  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.optim.optimizers import sgdm as jsgdm  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.kernels.layout import slab_view  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.train import paper_harness  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import VisionTask  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

TAC = dict(ladder="gpu", t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=1e-5,
           alpha=0.05, tau_curv=50.0, curvature_method="fisher")
SCHED = (0.05, 2, 10)
CLIP = 5.0
FIRST = ("['stem']", "['bn_stem']", "['s0b0']")


@pytest.fixture(scope="module")
def ref():
    """The reference's ResNet-18, its jitted resident step and a batch."""
    task = JVisionTask(JVisionConfig("resnet18"))
    wrapped, aux = jax.jit(task.init)(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    grouping = task.grouping(params)
    tac, opt = JTac(**TAC), jsgdm(0.9, 5e-4)
    view = jslab_view(params, grouping)
    step = jax.jit(jts.make_train_step(
        task, tac, opt, grouping, jwarmup(*SCHED), grad_clip=CLIP,
        resident_params=params))

    @jax.jit
    def state_for(codes, loss_scale):
        ctl = jinit_control(grouping.num_layers, tac)._replace(
            codes=codes, loss_scale=loss_scale)
        comp = jts.init_compute(task, params, grouping, ctl, tac)
        st = jts.TrainState(params, aux, opt.init(params), ctl, comp)
        return jts.pack_state(view, st, jnp.float32)

    batch = JStream(global_batch=2, seed=5).batch(0)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    return dict(step=step, state_for=state_for, batch=batch, names=names,
                L=grouping.num_layers)


def _port_step():
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    like, _ = task.init(torch.Generator(), device="meta")
    grouping = task.grouping(like)
    fn = make_train_step(task, TriAccelConfig(**TAC), sgdm(0.9, 5e-4),
                         grouping, warmup_cosine(*SCHED), grad_clip=CLIP,
                         resident_params=like)
    return fn, slab_view(like, grouping), grouping.names


def _carry(st):
    """A reference resident TrainState -> the port's, through numpy."""
    st = jax.device_get(st)
    return bridge.train_state(st.params, st.aux_state, st.opt_state,
                              st.control._asdict(), st.compute)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", ["bf16", "mixed", "nonfinite"])
def test_resident_step_matches_reference(ref, case):
    L = ref["L"]
    codes = np.ones(L, np.int32) if case == "bf16" else \
        np.arange(L, dtype=np.int32) % 3
    ls = np.float32(np.inf if case == "nonfinite" else 2.0 ** 15)
    jstate = ref["state_for"](jnp.asarray(codes), jnp.asarray(ls))
    jnew, jm = jax.device_get(ref["step"](jstate, ref["batch"]))

    fn, view, layer_names = _port_step()
    state = _carry(jstate)
    batch = {k: bridge.tensor(v) for k, v in
             jax.device_get(ref["batch"]).items()}
    new, m = fn(state, batch)

    finite = case != "nonfinite"
    assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == finite
    c, jc = new.control, jnew.control
    for k in ("step", "codes", "loss_scale", "good_steps", "ema_init"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    p0, p, jp = state.params.numpy(), _np(new.params), np.asarray(jnew.params)
    mo, jmo = _np(new.opt_state["mu"]), np.asarray(jnew.opt_state["mu"])
    cp, jcp = _np(new.compute["slab"]), np.asarray(jnew.compute["slab"])
    amax, jamax = new.compute["p_amax"].numpy(), jnew.compute["p_amax"]
    if not finite:
        # the skipped step keeps master, momentum and BN state; the copy
        # is recast from the unchanged master
        for a, b in ((p, p0), (p, jp), (mo, jmo), (cp, jcp), (amax, jamax),
                     (c.var_ema.numpy(), jc.var_ema)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(tu.leaves(new.aux_state),
                        tu.leaves(state.aux_state)):
            assert torch.equal(a, b)
        return

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for a, b in zip(tu.leaves(new.aux_state),
                    jax.tree.leaves(jnew.aux_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for name, slot in zip(ref["names"], view.slots):      # leaf by leaf
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        bound = (3e-2 if name.startswith(FIRST) else 2e-4) * \
            np.abs(jmo[rows]).max()
        assert np.abs(mo[rows] - jmo[rows]).max() <= bound, name
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr
    dev = np.abs((p - jp) + lr * (mo - jmo))
    assert np.all(dev <= 2.0 ** -21 * (np.abs(p0) + np.abs(jp)))
    assert np.all(np.abs(cp - jcp) <= 2.0 ** -7 * np.abs(jcp) + 2.0 ** -24)
    np.testing.assert_allclose(amax, np.asarray(jamax), rtol=2.0 ** -7)
    ve, jve = c.var_ema.numpy(), np.asarray(jc.var_ema)
    first = np.asarray([n in ("bn_stem", "s0b0", "stem")
                        for n in layer_names])
    np.testing.assert_allclose(ve[first], jve[first], rtol=5e-2)
    np.testing.assert_allclose(ve[~first], jve[~first], rtol=1e-3)


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


@pytest.mark.parametrize("args", [("fp32", "resnet18"),
                                  ("triaccel", "efficientnet_b0")])
def test_unported_methods_raise(args):
    """EfficientNet-B0 is not ported and raises. The FP32 baseline raised
    here until ``reference_step`` was ported: it now runs on the CPU, on
    the reference path over tree-form state, at the fixed rung, with the
    codes reported as fp32."""
    if args[0] != "fp32":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            paper_harness.run_method(*args, steps=1, device="cpu")
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
