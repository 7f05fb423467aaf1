"""The reference's NamedTuple defaults in the port: ``ControlState.lr_demote``
defaults to a plain 1.0 and ``Optimizer.spec`` to None, as in the JAX
package, so the short constructions of the reference (7 fields, 3 fields)
work in both packages.

  * a 7-field ``ControlState`` and a 3-field ``Optimizer`` construct in both
    packages and agree field by field, defaults included;
  * the checkpoint tree walk takes the plain-number ``lr_demote``: the port
    writes the reference's bytes for it and restores it as a number;
  * a spec-less sgdm optimizer resolves to the reference path
    (``train_step.reference_step``) in both packages, refuses the fused
    path in both, and trains two steps of ResNet-18 (batch 2, the reference
    step's test case) from a 7-field control state on the CPU, each step
    from the reference's state: the loss within rtol 1e-5, the momentum
    leaf by leaf within 2e-4 of the leaf's largest magnitude (3e-2 in the
    stem and first block, where XLA-CPU's own convolution gradient strays),
    the masters p_new - p_ref = -lr (m_new - m_ref) up to one f32 rounding
    on each side, 2^-21 (|p| + |p_new| + |p_ref|); step, codes, loss scale
    and lr equal, and ``lr_demote`` 1.0 (the plain number where the step
    started from one). The port's own
    two-step trajectory (its second step from its own first) takes the
    reference's second loss within rtol 1e-5.

    Each step is also taken in f64 from the same state, with the port's
    own model code, and with the ReLU gates of the port's f32 forward: the
    port's momentum is held there within F64_TOL = 2e-5 of the leaf's
    largest magnitude at every leaf (the f32 gradient sums up to 2,048
    terms a weight, ~45 x 2^-24 = 2.7e-6 relative, through ~20 layers;
    7.4e-6 is the largest seen, at both steps). A pre-activation within a
    few 1e-6 of zero can take the other side of its ReLU in one package's
    f32 forward than in the other's (or in f64): the gradient is not
    continuous there, and every leaf that the gate's backward reaches
    moves by the flip, not by rounding. At the
    second step the port's forward gates one element of s1b1's first ReLU
    otherwise than f64 does (its f64 pre-activation is 2.1e-6; XLA agrees
    with f64): the port's momentum then lies 6.1e-2 of the leaf's largest
    magnitude from the reference's in s1b1's conv1 (2.4e-2 in its bn1, 3e-3
    to 6e-3 in every leaf before it), and within 7.4e-6 of the f64 step
    taken with its own gates. So at the leaves upstream of a ReLU whose
    gate the port's forward sets otherwise than f64 the cross-package
    bound is FLIP_TOL = 1e-1, and the f64 bound above holds the port there.
"""
import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.core.controller import ControlState as JControl  # noqa: E402
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.data.synthetic import CIFARLikeStream as JStream  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.core.controller import ControlState  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import VisionTask  # noqa: E402

SCHED = (0.05, 2, 10)
CLIP = 5.0
#: the paper's FP32 baseline (the reference step without QDQ), as in
#: tests/test_torch_reference_step.py
STATIC = dict(t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=-1.0, alpha=0.05,
              tau_curv=50.0, curvature_method="fisher", ladder="gpu",
              enable_precision=False, enable_curvature=False,
              enable_batch=False, dynamic_precision=False)
FIRST = ("['stem']", "['bn_stem']", "['s0b0']")
#: the port's momentum against the f64 step taken with its own ReLU gates,
#: and the cross-package bound upstream of a gate that the port's f32
#: forward sets otherwise than f64 (module docstring)
F64_TOL, FLIP_TOL = 2e-5, 1e-1


def _seven(L=3):
    """The first seven ControlState fields as numpy arrays."""
    rng = np.random.default_rng(0)
    return dict(step=np.int32(4), var_ema=rng.random(L).astype(np.float32),
                lam=rng.random(L).astype(np.float32),
                codes=np.array([0, 1, 2][:L], np.int32),
                loss_scale=np.float32(2.0 ** 15), good_steps=np.int32(3),
                ema_init=np.int32(1))


def test_control_state_seven_fields_in_both_packages():
    """``ControlState(7 fields)`` builds in both packages with the same
    fields and the same default: ``lr_demote`` a plain 1.0."""
    f = _seven()
    j = JControl(**{k: jnp.asarray(v) for k, v in f.items()})
    t = ControlState(**{k: torch.from_numpy(np.array(v)) for k, v in
                        f.items()})
    assert JControl._fields == ControlState._fields
    assert JControl._field_defaults == ControlState._field_defaults == {
        "lr_demote": 1.0}
    assert type(j.lr_demote) is type(t.lr_demote) is float
    assert j.lr_demote == t.lr_demote == 1.0
    for k in f:
        np.testing.assert_array_equal(np.asarray(getattr(j, k)),
                                      getattr(t, k).numpy(), err_msg=k)
    c = bridge.control_state(jax.device_get(j)._asdict())
    assert c.lr_demote == 1.0 and type(c.lr_demote) is float


def test_optimizer_three_fields_in_both_packages():
    """``Optimizer(init, update, slots)`` builds in both packages with
    ``spec`` None; both resolve it to the reference path, and both refuse
    it on the fused path."""
    jo, to = jopt.sgdm(0.9, 5e-4), opt.sgdm(0.9, 5e-4)
    j3 = jopt.Optimizer(jo.init, jo.update, jo.slots)
    t3 = opt.Optimizer(to.init, to.update, to.slots)
    assert jopt.Optimizer._fields == opt.Optimizer._fields
    assert jopt.Optimizer._field_defaults == opt.Optimizer._field_defaults \
        == {"spec": None}
    assert j3.spec is None and t3.spec is None and j3.slots == t3.slots
    assert jo.spec is not None and to.spec is not None
    tac = dict(STATIC, tau_high=1e-5, dynamic_precision=True)
    assert not jts.resolve_fused(j3, JTac(**tac))
    assert not ts.resolve_fused(t3, TriAccelConfig(**tac))
    assert ts.resolve_fused(to, TriAccelConfig(**tac))
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    like, _ = task.init(torch.Generator(), device="meta")
    with pytest.raises(ValueError, match="kernel spec"):
        ts.make_train_step(task, TriAccelConfig(**tac), t3,
                           task.grouping(like), warmup_cosine(*SCHED),
                           fused_update=True)


def test_checkpoint_takes_the_plain_number_lr_demote(tmp_path):
    """A 7-field control state checkpoints in the port as in the reference
    (the same files, byte for byte, the plain 1.0 as the 0-d float64
    ``np.asarray`` makes it) and restores with ``lr_demote`` a number."""
    f = _seven()
    jstate = JControl(**{k: jnp.asarray(v) for k, v in f.items()})
    pstate = ControlState(**{k: torch.from_numpy(np.array(v)) for k, v in
                             f.items()})
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jck.save_checkpoint(str(jdir), 3, jax.device_get(jstate))
    ck.save_checkpoint(str(pdir), 3, pstate)
    a, b = jdir / "step_000000000003", pdir / "step_000000000003"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    manifest = ck._read_manifest(str(pdir), 3)
    assert manifest == jck._read_manifest(str(jdir), 3)
    assert manifest[".lr_demote"]["dtype"] == "float64"
    back = ck.restore_checkpoint(str(jdir), pstate)
    assert type(back.lr_demote) is float and back.lr_demote == 1.0
    for k in f:
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      getattr(pstate, k).numpy(), err_msg=k)


@pytest.fixture(scope="module")
def vision_ref():
    """The reference's ResNet-18 at batch 2 with a spec-less sgdm, its
    jitted reference step, the step's first two batches and a 7-field
    initial control state (the reference step's test case)."""
    task = JVisionTask(JVisionConfig("resnet18"))
    wrapped, aux = jax.jit(task.init)(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    grouping = task.grouping(params)
    jo = jopt.sgdm(0.9, 5e-4)
    jo3 = jopt.Optimizer(jo.init, jo.update, jo.slots)
    step = jax.jit(jts.make_train_step(
        task, JTac(**STATIC), jo3, grouping, jwarmup(*SCHED),
        grad_clip=CLIP))
    L = grouping.num_layers
    ctl = JControl(step=jnp.int32(0), var_ema=jnp.zeros(L, jnp.float32),
                   lam=jnp.zeros(L, jnp.float32),
                   codes=jnp.ones(L, jnp.int32),
                   loss_scale=jnp.float32(2.0 ** 15),
                   good_steps=jnp.int32(0), ema_init=jnp.int32(0))
    stream = JStream(global_batch=2, seed=5)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    return dict(step=step, names=names,
                state=jts.TrainState(params, aux, jo3.init(params), ctl),
                batches=[stream.batch(i) for i in range(2)])


def _port_state(jstate):
    st = jax.device_get(jstate)
    return ts.TrainState(bridge.tree(st.params), bridge.tree(st.aux_state),
                         bridge.tree(st.opt_state),
                         bridge.control_state(st.control._asdict()), ())


def _np(t):
    return t.detach().float().numpy()


class _Gates(types.ModuleType):
    """Stands for ``torch`` in the port's vision module: ``relu`` records
    each call's gate (``x > 0``), or, given the gates of another forward,
    applies those in their order."""

    def __init__(self, replay=None):
        super().__init__("torch")
        self.gates, self.replay = [], replay

    def __getattr__(self, name):
        return getattr(torch, name)

    def relu(self, x):
        if self.replay is None:
            self.gates.append(x.detach() > 0)
            return torch.relu(x)
        gate = self.replay[len(self.gates)]
        self.gates.append(gate)
        return x * gate.to(x.dtype)


def _upstream(site: int):
    """Leaf-name prefixes whose gradient passes through ResNet-18's ReLU
    number ``site`` in forward order (after the stem's BatchNorm, then in
    each block after bn1 and after the residual sum)."""
    blocks = [f"['s{i}b{j}']" for i in range(4) for j in range(2)]
    pre = ("['stem']", "['bn_stem']")
    if site == 0:
        return pre
    b, end = divmod(site - 1, 2)
    own = ((blocks[b],) if end else
           (f"{blocks[b]}['conv1']", f"{blocks[b]}['bn1']"))
    return pre + tuple(blocks[:b]) + own


def _f64_step(monkeypatch, task, state, batch):
    """The step's momentum in f64 from ``state`` (the port's model code,
    the ReLU gates of its f32 forward), and the leaf-name prefixes
    upstream of a gate that the f32 forward sets otherwise than f64."""
    def grads(dtype, gates):
        leaves, treedef = tu.flatten(state.params)
        wrt = [p.detach().to(dtype).requires_grad_(True) for p in leaves]
        monkeypatch.setattr(tv, "torch", gates)
        try:
            loss = task.loss(tu.unflatten(treedef, wrt),
                             tu.tree_map(lambda a: a.to(dtype),
                                         state.aux_state),
                             {"images": batch["images"].to(dtype),
                              "labels": batch["labels"]}, None, None)[0]
            return wrt, torch.autograd.grad(loss, wrt)
        finally:
            monkeypatch.setattr(tv, "torch", torch)

    own, own64 = _Gates(), _Gates()
    grads(torch.float32, own)
    grads(torch.float64, own64)
    flipped = [i for i, (a, b) in enumerate(zip(own.gates, own64.gates))
               if not torch.equal(a, b)]
    wrt, g = grads(torch.float64, _Gates(own.gates))
    gn = torch.sqrt(sum((x * x).sum() for x in g))
    clip = torch.clamp_max(CLIP / torch.clamp_min(gn, 1e-9), 1.0)
    mu = [0.9 * m.double() + clip * x + 5e-4 * p.detach() for m, x, p in
          zip(tu.leaves(state.opt_state["mu"]), g, wrt)]
    return mu, sum((_upstream(i) for i in flipped), ())


def _check(names, state, new, m, jnew, jm, f64):
    """One step of each package from the same state (reference_step's
    parity bounds), the port's momentum against the f64 step and the
    flip's wide bound (``f64``: ``_f64_step``'s result)."""
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["lr"]) == float(jm["lr"])
    c, jc = new.control, jnew.control
    for k in ("step", "codes", "loss_scale", "good_steps", "ema_init"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    assert type(c.lr_demote) is type(state.control.lr_demote)
    assert float(c.lr_demote) == float(jc.lr_demote) == 1.0
    lr = float(jm["lr"])
    p0 = [_np(x) for x in tu.leaves(state.params)]
    p = [_np(x) for x in tu.leaves(new.params)]
    jp = [np.asarray(x) for x in jax.tree.leaves(jnew.params)]
    mo = [_np(x) for x in tu.leaves(new.opt_state["mu"])]
    jmo = [np.asarray(x) for x in jax.tree.leaves(jnew.opt_state["mu"])]
    mu64, flip = f64
    for name, a0, a, b, ma, mb, m64 in zip(names, p0, p, jp, mo, jmo, mu64):
        rel = (FLIP_TOL if name.startswith(flip) else
               3e-2 if name.startswith(FIRST) else 2e-4)
        assert np.all(np.abs(ma - mb) <= rel * np.abs(mb).max()), name
        m64 = m64.numpy()
        assert np.all(np.abs(ma - m64) <= F64_TOL * np.abs(m64).max()), name
        dev = np.abs((a - b) + lr * (ma - mb))
        assert np.all(dev <= 2.0 ** -21 * (np.abs(a0) + np.abs(a)
                                           + np.abs(b))), name


def test_specless_sgdm_trains_on_the_reference_path(vision_ref,
                                                    monkeypatch):
    """A spec-less sgdm and a 7-field control state: two reference steps of
    ResNet-18 in the port against the reference's, each from the
    reference's state; the port's own second step (from its own first)
    takes the reference's second loss within rtol 1e-5."""
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    like, _ = task.init(torch.Generator(), device="meta")
    to = opt.sgdm(0.9, 5e-4)
    to3 = opt.Optimizer(to.init, to.update, to.slots)
    assert not ts.resolve_fused(to3, TriAccelConfig(**STATIC))
    step = ts.make_train_step(task, TriAccelConfig(**STATIC), to3,
                              task.grouping(like), warmup_cosine(*SCHED),
                              grad_clip=CLIP)
    batches = [{k: bridge.tensor(v) for k, v in jax.device_get(b).items()}
               for b in vision_ref["batches"]]
    jstate, own, losses = vision_ref["state"], None, []
    for i, jbatch in enumerate(vision_ref["batches"]):
        jnew, jm = jax.device_get(vision_ref["step"](jstate, jbatch))
        state = _port_state(jstate)
        # the reference's first state holds the plain 1.0; its jitted step
        # returns a 0-d f32 array, which crosses as a tensor
        assert (type(state.control.lr_demote) is float) == (i == 0)
        new, m = step(state, batches[i])
        assert bool(m["grads_finite"]) and bool(jm["grads_finite"])
        _check(vision_ref["names"], state, new, m, jnew, jm,
               _f64_step(monkeypatch, task, state, batches[i]))
        own, m_own = step(own if own is not None else state, batches[i])
        losses.append((float(m_own["loss"]), float(jm["loss"])))
        jstate = jnew
    assert type(own.control.lr_demote) is float
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
