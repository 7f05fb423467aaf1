"""Port parity for the reference training path (``reference_step``, the
tree-form unfused step behind the paper's FP32 baseline, the static-AMP
``--no-triaccel`` launcher baseline and the fused path's oracle), against
the reference package on the same numpy inputs:

  * ``core.precision.qdq`` and its gradient against ``jax.vjp`` of the
    reference's, both ladders, codes 0/1/2, f32 and bf16 — bitwise (NaN
    equal to NaN). The fp8 tier's gradient is the reference's transpose
    (``_qdq_fp8_vjp``), including the path through amax -> scale: a
    full-tensor sum that lands on the absmax element, bitwise on these
    inputs and held there within 2^-20 of the element's magnitude where
    sums in another order could round it otherwise;
  * ``moment_stats`` in both modes, within rtol 1e-6 (f32 sums in another
    order); ``sgdm``/``adamw`` ``update``, ``apply_updates`` and
    ``global_norm`` on random trees with per-leaf and scalar learning
    rates: the sgdm update, moments and masters bitwise (one rounding per
    operation on both sides); adamw's moments within rtol 1e-6 and its
    masters within rtol 1e-6 plus 2^-22 of the three updates' summed
    magnitudes (``ADAMW_MASTER_BOUND``); the norm within rtol 1e-6;
  * one ``reference_step`` of ResNet-18 (batch 2; in
    ``test_torch_reference_step_vision.py`` and, the tpu ladder's case
    and the non-finite step, ``test_torch_reference_step_vision_tpu.py``:
    files of their own, so xdist's loadfile workers share them) and of
    the reduced LM
    (``flash_test_config(2)``, S 256, B 2), carried from the reference's
    state: the FP32 / static baseline (no QDQ), dynamic precision with
    mixed codes on each ladder (the in-loss QDQ), and a non-finite step
    (loss scale inf) that must keep params, moments and aux state bitwise.
    Tolerances as the resident steps' (``test_torch_train_step``,
    ``test_torch_lm_train``): loss rtol 1e-5 (LM 1e-4); BN state rtol
    1e-5; the momentum (after one step from zero: the clipped, unscaled
    gradient plus weight decay) leaf by leaf within 2e-4 of the leaf's
    largest magnitude (3e-2 in ResNet-18's stem and first block, where
    XLA-CPU's own convolution gradient strays; 5e-2 for the bf16 LM; 1e-1
    for ResNet-18 under the in-loss QDQ, where the reference's XLA-CPU
    gradient strays from an f64 evaluation by up to 3e-2 of a leaf's
    largest magnitude and the port's stays within one bf16 step of it,
    ``test_vision_qdq_gradient_matches_f64``), plus,
    under the in-loss QDQ, one step of the leaf's tier per element: QDQ's
    transpose rounds the gradient through fp16 / bf16 / fp8 as the forward
    rounds the weight, so gradients that differ in their last f32 bits can
    round one grid step apart (2^-10, 2^-7, 2^-3 of the element, and the
    tier's smallest step below its normal range); the
    master p_new - p_ref = -lr (m_new - m_ref) up to one f32 rounding on
    each side, 2^-21 (|p| + |p_new| + |p_ref|); codes, step and loss scale
    equal; var_ema within rtol 5e-2 in ResNet-18's first layers, 1e-3
    elsewhere, 1e-2 for the LM, and 0.5 in the one fp8-coded layer (at the
    tpu ladder's loss scale of 1 its gradient sits on fp8's subnormal grid,
    2^-9 x 448 / absmax, where most entries round to zero, so one flipped
    step moves the variance by a large fraction: measured 0.27);
  * the port's resident fused step against the port's own
    ``reference_step`` (the fused path's oracle) from the same state on
    one Tri-Accel config with every code at fp32 (so neither path rounds
    its weights): the same loss bitwise, momentum within 2^-20 of each
    leaf's largest magnitude and masters within 2^-21 (|p| + |p'|) plus
    lr times that momentum gap (the fused path unscales and clips by one
    product in its kernel, the reference by two roundings).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.core.controller import init_control as jinit_control  # noqa
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.data.synthetic import CIFARLikeStream as JStream  # noqa: E402
from repro.data.synthetic import LMTaskStream as JLMStream  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.core.controller import init_control  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.kernels.layout import slab_view  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import LMTask, VisionTask  # noqa: E402

SCHED = (0.05, 2, 10)
CLIP = 5.0
BASE = dict(t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=1e-5, alpha=0.05,
            tau_curv=50.0, curvature_method="fisher")
#: the step's configurations: the paper's FP32 baseline (the launcher's
#: --no-triaccel is the same switches), and dynamic precision (in-loss QDQ)
#: on each ladder
TACS = {
    "static": dict(BASE, ladder="gpu", tau_high=-1.0, enable_precision=False,
                   enable_curvature=False, enable_batch=False,
                   dynamic_precision=False),
    "qdq_gpu": dict(BASE, ladder="gpu"),
    "qdq_tpu": dict(BASE, ladder="tpu"),
}
FIRST = ("['stem']", "['bn_stem']", "['s0b0']")


def _np(t):
    return t.detach().float().numpy()


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


# ------------------------------------------------------------------ qdq ---
@pytest.mark.parametrize("ladder", ["gpu", "tpu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", [0, 1, 2])
def test_qdq_and_its_gradient_match_jax(ladder, dtype, code):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 17)).astype(np.float32) * 3
    x[0, :4] = [1e-9, -7e-6, 70000.0, 0.0]        # f16 underflow/overflow
    ct = rng.standard_normal((33, 17)).astype(np.float32)
    ct[1, :3] = [1e-8, -3e-7, 0.0]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jct = jnp.asarray(ct).astype(getattr(jnp, dtype))
    y, vjp = jax.vjp(lambda v: jprec.qdq(v, jnp.asarray(code), ladder), jx)
    (g,) = vjp(jct)
    xt = bridge.tensor(jax.device_get(jx)).requires_grad_(True)
    yt = prec.qdq(xt, torch.tensor(code, dtype=torch.int32), ladder)
    (gt,) = torch.autograd.grad(yt, xt, bridge.tensor(jax.device_get(jct)))
    assert yt.dtype == xt.dtype and gt.dtype == xt.dtype
    assert _same(_np(yt), y)
    gap = np.abs(_np(gt) - np.asarray(g, np.float32))
    amax = np.abs(np.asarray(jx, np.float32))
    at_max = amax == amax.max()
    assert _same(_np(gt)[~at_max], np.asarray(g, np.float32)[~at_max])
    assert np.all(gap[at_max] <= 2.0 ** -20 * np.abs(np.asarray(
        g, np.float32))[at_max])


def test_qdq_fp8_gradient_shares_ties_and_takes_the_amax_path():
    """Two elements tie for the absmax: the amax path's term is shared
    between them as ``jnp.max``'s rule shares it."""
    x = np.linspace(-2.0, 3.0, 40, dtype=np.float32)
    x[5] = -3.0
    ct = np.cos(np.arange(40, dtype=np.float32))
    y, vjp = jax.vjp(lambda v: jprec._qdq_fp8(v), jnp.asarray(x))
    (g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(prec.qdq(xt, 0, "tpu"), xt,
                                torch.from_numpy(ct))
    np.testing.assert_allclose(_np(gt), np.asarray(g), rtol=2.0 ** -20,
                               atol=0)
    # without the amax path the gradient would be the cast's transpose
    # alone; it differs exactly at the two tied elements
    scale = prec.cast_scales(torch.tensor(3.0))
    main = prec._fp8_round(torch.from_numpy(ct) / scale) * scale
    ties = np.zeros(40, bool)
    ties[[5, 39]] = True
    assert not np.any(_np(gt)[ties] == _np(main)[ties])
    np.testing.assert_array_equal(_np(gt)[~ties], _np(main)[~ties])


def test_qdq_code_stays_on_the_device_and_skips_integers():
    x = torch.randn(8, requires_grad=True)
    codes = torch.tensor([0, 1, 2], dtype=torch.int32)
    out = [prec.qdq(x, c) for c in codes.unbind(0)]
    assert torch.equal(out[2], x) and not torch.equal(out[1], x)
    n = torch.arange(4)
    assert prec.qdq(n, 0) is n
    assert prec.make_qdq_fn(TriAccelConfig(dynamic_precision=False)) is None
    fn = prec.make_qdq_fn(TriAccelConfig(ladder="tpu"))
    assert torch.equal(fn(x, 0), prec.qdq(x, 0, "tpu"))


# -------------------------------------------------------- moment_stats ---
@pytest.mark.parametrize("layer_axis", [False, True])
def test_moment_stats_matches_reference(layer_axis):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 30, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 11)).astype(np.float32),
                  "i": np.arange(4, dtype=np.int32)}}
    want = jprec.moment_stats(jax.tree.map(jnp.asarray, tree), layer_axis)
    got = prec.moment_stats(bridge.tree(tree), layer_axis)
    for a, b in zip(got, want):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------- optimizers ---
#: Why adamw's masters need more than rtol 1e-6. The bias corrections
#: c = 1 - b ** t come from two libraries' ``pow`` (XLA's and libm's
#: through torch). Both round 0.9 ** t and 0.95 ** t correctly in most
#: hosts' runs, and the two packages then agree bitwise here. One run on
#: another host failed at one element, 1.15e-6 relative, and only with
#: per-leaf rates. Measured with an f32 emulation of the update (one rounding
#: an operation, bitwise the port's) and exact rationals: f32(0.95) ** 3 =
#: 0.857374967724 exactly, 0.0265 of an ulp above the f32 below it, so a
#: correctly rounded c2 at step 3 is 0.14262503 (the port's). A pow one ulp
#: high there gives c2 = 0.14262497. That change alone moves exactly one
#: master over rtol 1e-6: ``b[1, 2]``, by 1.49e-8 = 1.146e-6 of its
#: -0.0130016. Its three updates sum to 0.583 in magnitude and cancel to
#: that value, which amplifies one ulp of an update 45 times. So a
#: bias correction one ulp off moves an update by at most ~2^-23 of
#: itself, and a master by at most 2^-22 of its updates' summed magnitudes.
#: Over all twelve one-ulp changes of c1 or c2 at any step, the largest
#: error is 0.39 of that bound with per-leaf rates and 0.19 with the
#: scalar rate. The moments take no c and stay within rtol 1e-6.
ADAMW_MASTER_BOUND = 2.0 ** -22


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 5, 4), "b": (3, 4), "u": {"x": (6,)}}
    mk = lambda scale: jax.tree.map(                       # noqa: E731
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    lr = {"w": np.asarray([0.1, 0.2, 0.3], np.float32).reshape(3, 1, 1),
          "b": np.asarray([0.1, 0.2, 0.3], np.float32).reshape(3, 1),
          "u": {"x": np.float32(0.05)}}
    return mk(1.0), mk(1e-2), lr


@pytest.mark.parametrize("name", ["sgdm", "sgdm_nesterov", "adamw"])
@pytest.mark.parametrize("per_leaf", [True, False])
def test_tree_optimizer_matches_reference(name, per_leaf):
    params, grads, lr_tree = _opt_inputs(11)
    make = {"sgdm": lambda m: m.sgdm(0.9, 5e-4),
            "sgdm_nesterov": lambda m: m.sgdm(0.9, 5e-4, nesterov=True),
            "adamw": lambda m: m.adamw(weight_decay=1e-2)}[name]
    jo, po = make(jopt), make(opt)
    jp = jax.tree.map(jnp.asarray, params)
    pp = bridge.tree(params)
    jstate, pstate = jo.init(jp), po.init(pp)
    moved = [np.zeros(np.shape(x), np.float64) for x in tu.leaves(pp)]
    for step in range(3):                 # moments carried over 3 steps
        g = jax.tree.map(lambda x: x * (step + 1), grads)
        lr = lr_tree if per_leaf else np.float32(0.03)
        ju, jstate = jo.update(jax.tree.map(jnp.asarray, g), jstate, jp,
                               jax.tree.map(jnp.asarray, lr))
        pu, pstate = po.update(bridge.tree(g), pstate, pp,
                               bridge.tree(lr) if per_leaf
                               else torch.tensor(0.03))
        jp, pp = jopt.apply_updates(jp, ju), opt.apply_updates(pp, pu)
        moved = [s + np.abs(_np(u)) for s, u in zip(moved, tu.leaves(pu))]
    pairs = [(tu.leaves(pp), jax.tree.leaves(jp))]
    for k in ("mu", "m", "v"):
        if k in jstate:
            pairs.append((tu.leaves(pstate[k]), jax.tree.leaves(jstate[k])))
    for i, (got, want) in enumerate(pairs):
        for j, (a, b) in enumerate(zip(got, want)):
            if name == "adamw" and i == 0:
                # the masters: rtol 1e-6 plus the bias corrections' ulp
                # (ADAMW_MASTER_BOUND), 2^-22 of the updates' magnitudes
                err = np.abs(_np(a).astype(np.float64) - np.asarray(b))
                bnd = (1e-6 * np.abs(np.asarray(b))
                       + ADAMW_MASTER_BOUND * moved[j])
                assert (err <= bnd).all(), (j, float((err / bnd).max()))
            elif name == "adamw":
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
            else:
                np.testing.assert_array_equal(_np(a), np.asarray(b))
    if name == "adamw":
        assert int(pstate["t"]) == int(jstate["t"]) == 3
    np.testing.assert_allclose(float(opt.global_norm(pp)),
                               float(jopt.global_norm(jp)), rtol=1e-6)


# ----------------------------------------------------- reference step ----
def _tree_state(st):
    """A reference tree-form TrainState -> the port's, through numpy."""
    st = jax.device_get(st)
    return ts.TrainState(bridge.tree(st.params), bridge.tree(st.aux_state),
                         bridge.tree(st.opt_state),
                         bridge.control_state(st.control._asdict()), ())


def _ref_steps(task, params, aux):
    """The reference's jitted reference_step per configuration, and the
    state its tests start from (given codes and loss scale)."""
    grouping = task.grouping(params)
    jo = jopt.sgdm(0.9, 5e-4)
    steps = {k: jax.jit(jts.make_train_step(
        task, JTac(**tac), jo, grouping, jwarmup(*SCHED), grad_clip=CLIP,
        fused_update=False)) for k, tac in TACS.items()}

    def state_for(which, codes, loss_scale):
        ctl = jinit_control(grouping.num_layers, JTac(**TACS[which]))._replace(
            codes=jnp.asarray(codes), loss_scale=jnp.float32(loss_scale))
        return jts.TrainState(params, aux, jo.init(params), ctl)

    return steps, state_for, grouping.num_layers


def _port_fn(task, which):
    like, _ = task.init(torch.Generator(), device="meta")
    return ts.make_train_step(task, TriAccelConfig(**TACS[which]),
                              opt.sgdm(0.9, 5e-4), task.grouping(like),
                              warmup_cosine(*SCHED), grad_clip=CLIP,
                              fused_update=False)


@pytest.fixture(scope="module")
def vision_ref():
    task = JVisionTask(JVisionConfig("resnet18"))
    wrapped, aux = jax.jit(task.init)(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    steps, state_for, L = _ref_steps(task, params, aux)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    return dict(steps=steps, state_for=state_for, L=L, names=names,
                batch=JStream(global_batch=2, seed=5).batch(0))


@pytest.fixture(scope="module")
def lm_ref():
    cfg = jconf._make(2, 64, 4, 2, 16, 128, 512, impl="flash")
    task = JLMTask(cfg)
    wrapped, aux = task.init(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    steps, state_for, L = _ref_steps(task, params, aux)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    return dict(steps=steps, state_for=state_for, L=L, names=names,
                batch=JLMStream(512, 256, 2, seed=5).batch(0))


CASES = ["static", "qdq_gpu", "qdq_tpu", "nonfinite"]


def _codes(case, L, fp8_layer):
    """Mixed codes; on the tpu ladder code 0 (fp8) goes to ``fp8_layer``
    alone."""
    if not case.startswith("qdq"):
        return np.ones(L, np.int32)
    codes = np.arange(L, dtype=np.int32) % 3
    if case == "qdq_tpu":
        codes = np.maximum(codes, 1)
        codes[fp8_layer] = 0
    return codes


#: relative grid step and smallest (subnormal) step of each tier's
#: gradient rounding, for a code's layers; code 2 does not round
TIER_STEP = {("gpu", 0): (2.0 ** -10, 2.0 ** -24),
             ("tpu", 0): (2.0 ** -3, 2.0 ** -9), (1,): (2.0 ** -7, 0.0)}


def _tier_slack(task, case, codes, params, ls):
    """Per leaf, (relative, absolute) slack for one grid step of the tier
    that QDQ's transpose rounds its gradient through (in gradient units:
    the rounding happens on the loss-scaled cotangent, and fp8's grid is
    scaled by 448 / the weight's absmax)."""
    if not case.startswith("qdq"):
        return [(0.0, 0.0)] * len(tu.leaves(params))
    ladder = case.split("_")[1]
    grouping = task.grouping(params)
    n_act = task.loss_codes(torch.zeros(grouping.num_layers)).shape[0]
    layer = tu.leaves(grouping.broadcast(
        torch.arange(grouping.num_layers), params))
    out = []
    for w, ids in zip(tu.leaves(params), layer):
        ids = ids.numpy()
        code = np.where(ids < n_act, codes[np.minimum(ids, n_act - 1)], 2)
        cw = w.to(task.compute_dtype)
        if cw.dtype == torch.bfloat16:
            code = np.where(code == 1, 2, code)        # bf16 tier: no-op
        rel = np.where(code == 0, TIER_STEP[(ladder, 0)][0],
                       np.where(code == 1, TIER_STEP[(1,)][0], 0.0))
        floor = TIER_STEP[(ladder, 0)][1] / ls
        if ladder == "tpu":                            # per qdq call
            amax = (cw.float().abs().reshape(cw.shape[0], -1).amax(1)
                    if ids.ndim else cw.float().abs().amax())
            floor = floor * (448.0 / amax.numpy()).reshape(ids.shape)
        out.append((rel, np.where(code == 0, floor, 0.0)))
    return out


def _check_step(ref, task, case, loss_rtol, mom_rel, ema_rtol, fp8_layer,
                fp8_finite=True):
    which = "static" if case == "nonfinite" else case
    # the tpu ladder runs without loss scaling (its init scale is 1)
    ls = {"nonfinite": np.inf, "qdq_tpu": 1.0}.get(case, 2.0 ** 15)
    codes = _codes(case, ref["L"], fp8_layer)
    jstate = ref["state_for"](which, codes, ls)
    jnew, jm = jax.device_get(ref["steps"][which](jstate, ref["batch"]))
    state = _tree_state(jstate)
    batch = {k: bridge.tensor(v) for k, v in
             jax.device_get(ref["batch"]).items()}
    new, m = _port_fn(task, which)(state, batch)

    finite = case != "nonfinite" and (case != "qdq_tpu" or fp8_finite)
    assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == finite
    assert new.compute == ()
    c, jc = new.control, jnew.control
    for k in ("step", "codes", "loss_scale", "good_steps", "ema_init"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    p0 = [_np(x) for x in tu.leaves(state.params)]
    p = [_np(x) for x in tu.leaves(new.params)]
    jp = [np.asarray(x) for x in jax.tree.leaves(jnew.params)]
    mo = [_np(x) for x in tu.leaves(new.opt_state["mu"])]
    jmo = [np.asarray(x) for x in jax.tree.leaves(jnew.opt_state["mu"])]
    aux = [_np(x) for x in tu.leaves(new.aux_state)]
    jaux = [np.asarray(x) for x in jax.tree.leaves(jnew.aux_state)]
    if not finite:
        # the skipped step keeps params, momentum and aux state
        for a, b in zip(p + mo + aux, p0 + [np.zeros_like(x) for x in p0]
                        + [_np(x) for x in tu.leaves(state.aux_state)]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(p + mo + aux, jp + jmo + jaux):
            np.testing.assert_array_equal(a, b)
        return
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=loss_rtol)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr
    slack = _tier_slack(task, case, codes, state.params, float(ls))
    for name, a0, a, b, ma, mb, (t_rel, t_abs) in zip(
            ref["names"], p0, p, jp, mo, jmo, slack):
        lim = (mom_rel(name) * np.abs(mb).max()
               + t_rel * (np.abs(ma) + np.abs(mb) + 5e-4 * np.abs(a0))
               + t_abs)
        assert np.all(np.abs(ma - mb) <= lim), name
        dev = np.abs((a - b) + lr * (ma - mb))
        assert np.all(dev <= 2.0 ** -21 * (np.abs(a0) + np.abs(a)
                                           + np.abs(b))), name
    ve, jve = c.var_ema.numpy(), np.asarray(jc.var_ema)
    for i, (x, y) in enumerate(zip(ve, jve)):
        rtol = 0.5 if codes[i] == 0 and case == "qdq_tpu" else ema_rtol(i)
        np.testing.assert_allclose(x, y, rtol=rtol, err_msg=str(i))


def check_vision_reference_step(vision_ref, case):
    """One ResNet-18 ``reference_step`` of ``case`` against the
    reference's (the vision files' parametrized test)."""
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    layer_names = task.grouping(task.init(torch.Generator(),
                                          device="meta")[0]).names
    first = {i for i, n in enumerate(layer_names)
             if n in ("bn_stem", "s0b0", "stem")}
    # fp8 on the stem: every other layer holds an all-zero leaf at init
    # (BatchNorm biases), whose fp8 gradient is NaN in the reference
    # (0 * inf on its amax path; see the LM case)
    qdq = case.startswith("qdq")
    _check_step(vision_ref, task, case, 1e-5,
                lambda n: 1e-1 if qdq else (3e-2 if n.startswith(FIRST)
                                             else 2e-4),
                lambda i: 5e-2 if i in first else 1e-3,
                fp8_layer=layer_names.index("stem"))


@pytest.mark.parametrize("case", CASES)
def test_lm_reference_step_matches_reference(lm_ref, case):
    task = LMTask(conf.flash_test_config(2), device="cpu")
    # fp8 on layer 0, whose norm scales start at zero: the reference's fp8
    # gradient of an all-zero tensor is NaN (its amax path multiplies 0 by
    # amax^-2 = inf), so both sides must skip the step and keep the state
    _check_step(lm_ref, task, case, 1e-4, lambda n: 5e-2, lambda i: 1e-2,
                fp8_layer=0, fp8_finite=False)


# ------------------------------------- the fused path and its oracle -----
def test_resident_step_matches_the_ports_reference_step():
    task = VisionTask(VisionConfig("resnet18"), device="cpu")
    params, aux = task.init(torch.Generator().manual_seed(1))
    grouping = task.grouping(params)
    tac = TriAccelConfig(**dict(BASE, ladder="gpu", enable_curvature=False))
    o = opt.sgdm(0.9, 5e-4)
    ctl = init_control(grouping.num_layers, tac)._replace(
        codes=torch.full((grouping.num_layers,), 2, dtype=torch.int32))
    like = tu.tree_map(lambda x: x.to("meta"), params)
    kw = dict(grad_clip=CLIP)
    ref_fn = ts.make_train_step(task, tac, o, grouping, warmup_cosine(*SCHED),
                                fused_update=False, **kw)
    fus_fn = ts.make_train_step(task, tac, o, grouping, warmup_cosine(*SCHED),
                                resident_params=like, **kw)
    view = slab_view(params, grouping)
    tree = ts.TrainState(params, aux, o.init(params), ctl)
    comp = ts.init_compute(task, params, grouping, ctl, tac)
    slab = ts.pack_state(view, tree._replace(compute=comp), torch.float32)
    batch = task.data_stream(2, seed=4).batch(0)
    rnew, rm = ref_fn(tree, batch)
    fnew, fm = fus_fn(slab, batch)
    assert torch.equal(rm["loss"], fm["loss"])
    assert torch.equal(rnew.control.codes, fnew.control.codes)
    out = ts.unpack_state(view, fnew, params)
    lr = float(rm["lr"])
    for a0, a, b, ma, mb in zip(tu.leaves(params), tu.leaves(rnew.params),
                                tu.leaves(out.params),
                                tu.leaves(rnew.opt_state["mu"]),
                                tu.leaves(out.opt_state["mu"])):
        mgap = float((ma - mb).abs().max())
        assert mgap <= 2.0 ** -20 * float(ma.abs().max())
        lim = 2.0 ** -21 * (a0.abs() + a.abs()) + lr * mgap
        assert bool(((a - b).abs() <= lim).all())
    for a, b in zip(tu.leaves(rnew.aux_state), tu.leaves(out.aux_state)):
        assert torch.equal(a, b)
