"""Port parity for one slab-resident LM train step carried from the
reference's state, and the serving amax table that a trained state feeds
to ``tier_params``. The model, the checks and their tolerances are
``test_torch_lm_train.py``'s (its docstring).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.controller import init_control as jinit_control  # noqa
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.kernels.layout import slab_view as jslab_view  # noqa: E402
from repro.optim.optimizers import sgdm as jsgdm  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.layout import slab_view  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_lm_train import (B, CLIP, S, SCHED, TAC,  # noqa: E402
                                 _batch, _one_intra_op_thread,
                                 _process_state, ref)


# ------------------------------------------------------------------ step --
@pytest.fixture(scope="module")
def ref_step(ref):
    task, params, grouping = ref["task"], ref["params"], ref["grouping"]
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
        st = jts.TrainState(params, ref["aux"], opt.init(params), ctl, comp)
        return jts.pack_state(view, st, jnp.float32)

    return dict(step=step, state_for=state_for, L=grouping.num_layers)


def _port_step():
    task = LMTask(conf.flash_test_config(2), device="cpu")
    like, _ = task.init(torch.Generator(), device="meta")
    grouping = task.grouping(like)
    fn = make_train_step(task, TriAccelConfig(**TAC), sgdm(0.9, 5e-4),
                         grouping, warmup_cosine(*SCHED), grad_clip=CLIP,
                         resident_params=like)
    return fn, slab_view(like, grouping)


@pytest.mark.parametrize("case", ["bf16", "nonfinite"])
def test_resident_lm_step_matches_reference(ref, ref_step, case):
    L = ref_step["L"]
    ls = np.float32(np.inf if case == "nonfinite" else 2.0 ** 15)
    jstate = ref_step["state_for"](jnp.ones(L, jnp.int32), jnp.asarray(ls))
    jnew, jm = jax.device_get(ref_step["step"](jstate, ref["batch"]))

    fn, view = _port_step()
    js = jax.device_get(jstate)
    state = bridge.train_state(js.params, js.aux_state, js.opt_state,
                               js.control._asdict(), js.compute)
    new, m = fn(state, _batch(ref))

    finite = case != "nonfinite"
    assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == finite
    c, jc = new.control, jnew.control
    for k in ("step", "codes", "loss_scale", "good_steps", "ema_init"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    f = lambda t: t.detach().float().numpy()     # noqa: E731
    p0, p, jp = state.params.numpy(), f(new.params), np.asarray(jnew.params)
    mo, jmo = f(new.opt_state["mu"]), np.asarray(jnew.opt_state["mu"])
    cp, jcp = f(new.compute["slab"]), np.asarray(
        jnew.compute["slab"]).astype(np.float32)
    if not finite:
        for a, b in ((p, p0), (p, jp), (mo, jmo), (cp, jcp),
                     (new.compute["p_amax"].numpy(),
                      jnew.compute["p_amax"]),
                     (c.var_ema.numpy(), jc.var_ema)):
            np.testing.assert_array_equal(a, np.asarray(b))
        return
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for slot in view.slots:                           # leaf by leaf
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        bound = 5e-2 * np.abs(jmo[rows]).max()
        assert np.abs(mo[rows] - jmo[rows]).max() <= bound, slot.shape
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr
    dev = np.abs((p - jp) + lr * (mo - jmo))
    assert np.all(dev <= 2.0 ** -21 * (np.abs(p0) + np.abs(p) + np.abs(jp)))
    # the copy is the master cast to bf16 on each side: within the
    # masters' gap plus half a bf16 step of each (masters near zero, the
    # zero-initialised norm scales after one step, carry the gradient's
    # relative gap into their copies)
    lim = np.abs(p - jp) + 2.0 ** -8 * (np.abs(p) + np.abs(jp)) + 2.0 ** -24
    assert np.all(np.abs(cp - jcp) <= lim)
    np.testing.assert_allclose(c.var_ema.numpy(), np.asarray(jc.var_ema),
                               rtol=1e-2)


# ------------------------------------------------- serving amax table --
def test_serving_amax_tree_feeds_tier_params():
    """As the reference's ``tests/test_fused_update.py::
    test_serving_amax_tree_feeds_tier_params``: after two fused steps on
    the tpu ladder the carried table bounds every leaf's true absmax of
    the bf16-cast master, and the tier-0 weight set built from it equals
    ``qdq_cast`` with the same amax, bitwise (the reference's tier-0 set
    with a given table: ``tests/test_torch_qdq_cast_out.py``). None on the
    reference path."""
    from repro_torch.serve import engine
    task = LMTask(conf.flash_test_config(2), device="cpu")
    tac = TriAccelConfig(ladder="tpu", t_ctrl=1000, enable_curvature=False,
                         enable_batch=False, mem_cap_bytes=8e9)
    tcfg = TrainerConfig(total_steps=2, seq_len=S, rungs=(B,),
                         log_every=1000)
    tr = Trainer(task, tac, tcfg, device="cpu")
    tr.run(2)
    amax_tree = tr.serving_amax_tree()
    params = tr.params_tree()
    leaves, amaxes = tu.leaves(params), tu.leaves(amax_tree)
    assert len(leaves) == len(amaxes)
    for leaf, amax in zip(leaves, amaxes):
        true = leaf.detach().to(torch.bfloat16).float().abs().max()
        assert amax.shape == () and float(amax) >= float(true)
    got = engine.tier_params(params, 0, "tpu", amax_tree=amax_tree)
    for leaf, amax, want in zip(leaves, amaxes, tu.leaves(got)):
        direct = ops.qdq_cast(leaf.detach().float(), 0, "tpu", amax)
        assert torch.equal(want.view(torch.int16),
                           direct.to(torch.bfloat16).view(torch.int16))
    off = Trainer(task, tac, TrainerConfig(seq_len=S, rungs=(B,),
                                           fused_update=False),
                  device="cpu")
    assert off.serving_amax_tree() is None


def test_serving_amax_tree_matches_reference_on_a_bridged_state(ref,
                                                                 ref_step):
    """The port's table on the reference's state after one resident step,
    bridged as in ``test_resident_lm_step_matches_reference``, equals the
    reference's, leaf for leaf: held against the reference's
    ``view.amax_tree`` over the same ``p_amax`` (a reference ``Trainer``
    would compile its whole step again)."""
    L = ref_step["L"]
    jstate = ref_step["state_for"](jnp.ones(L, jnp.int32),
                                   jnp.asarray(np.float32(2.0 ** 15)))
    js, _ = jax.device_get(ref_step["step"](jstate, ref["batch"]))
    want = jslab_view(ref["params"], ref["grouping"]).amax_tree(
        jnp.asarray(js.compute["p_amax"]), ref["params"])
    tr = Trainer(LMTask(conf.flash_test_config(2), device="cpu"),
                 TriAccelConfig(**TAC), TrainerConfig(seq_len=S,
                                                      rungs=(B,)),
                 device="cpu")
    tr.state = bridge.train_state(js.params, js.aux_state, js.opt_state,
                                  js.control._asdict(), js.compute)
    got = tr.serving_amax_tree()
    wl = jax.tree.leaves(jax.device_get(want))
    gl = tu.leaves(got)
    assert len(wl) == len(gl) == len(tu.leaves(tr.params_tree()))
    for w, g in zip(wl, gl):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
