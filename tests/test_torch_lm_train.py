"""Port parity for the LM training path: ``lm_loss`` and its gradient, the
stack's train mode under checkpointing, ``lm_grouping`` and the slab over
an LM tree, ``LMTaskStream``, one slab-resident train step carried from
the reference, and the launcher.

The model is smollm-135m's shape at reduced width on the flash path
(``configs.smollm_135m.flash_test_config``: 2 layers, d 64, 4 heads, kv 2,
head_dim 16, d_ff 128, vocab 512), S 256, B 2, so both sides take their
attention kernels (the reference's Pallas kernels in interpret mode, the
port's plain versions through the autograd Function). Weights come from
the reference's init (``bridge.lm_params``), batches from the reference's
``LMTaskStream``.

Tolerances (the model computes in bf16, as trained; torch and XLA round
the bf16 projections, activations and RoPE after sums taken in another
order, one bf16 ulp, 2^-8 relative, here and there):
  * the loss within rtol 1e-4 (measured gaps about 1e-6);
  * the gradient, leaf by leaf, within 5e-2 of the leaf's largest
    magnitude (measured below 1.2e-2): each bf16 rounding that differs
    moves a few gradient entries by about one ulp of their operands;
  * the grouping's counts and names equal; its sums within rtol 1e-5
    (f32 sums in another order); broadcast and the slab's row layers
    equal;
  * the resident step: codes, step and loss scale equal; the momentum slab
    (the clipped, unscaled gradient after one step from zero momentum)
    leaf by leaf within 5e-2 of the leaf's largest magnitude, as the
    gradient; the master p_new - p_ref = -lr (m_new - m_ref) up to one f32
    rounding on each side, each relative to its own values, 2^-21 (|p| +
    |p_new| + |p_ref|); the next compute copy (the master
    cast to bf16 on each side) within the masters' gap plus half a bf16
    step of each, 2^-8 (|p| + |p_ref|), plus 2^-24; var_ema within rtol
    1e-2 (measured below 1e-3); the skipped (non-finite) step bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.core.batch_scaler import MemoryModel as JMemoryModel  # noqa
from repro.core.controller import init_control as jinit_control  # noqa
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.data.synthetic import LMTaskStream as JStream  # noqa: E402
from repro.kernels.layout import slab_view as jslab_view  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.optim.optimizers import sgdm as jsgdm  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.batch_scaler import MemoryModel  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.data.synthetic import LMTaskStream, affine_orbit  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.layout import slab_view  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import blocks  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

S, B, VOCAB = 256, 2, 512
TAC = dict(ladder="gpu", t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=1e-5,
           alpha=0.05, tau_curv=50.0, curvature_method="fisher")
SCHED = (0.05, 2, 10)
CLIP = 5.0


@pytest.fixture(autouse=True)
def _process_state():
    """Leave nothing process-wide changed for the test files that share
    this worker: the fallback warnings, the launch counts, TF32 and the
    default dtype; and no test may leave ``flash_fallback`` on."""
    warned, launches = set(ops.WARNED_FALLBACKS), dict(ops.LAUNCHES)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    dtype = torch.get_default_dtype()
    yield
    ops.WARNED_FALLBACKS.clear()
    ops.WARNED_FALLBACKS.update(warned)
    ops.LAUNCHES.update(launches)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    torch.set_default_dtype(dtype)
    assert not ops.fallback_forced()


@pytest.fixture(scope="module")
def ref():
    """The reference's flash-path LM, its params, grouping and a batch."""
    cfg = jconf._make(2, 64, 4, 2, 16, 128, VOCAB, impl="flash")
    task = JLMTask(cfg)
    wrapped, aux = task.init(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    batch = JStream(VOCAB, S, B, seed=5).batch(0)
    return dict(cfg=cfg, task=task, params=params, aux=aux, batch=batch,
                grouping=task.grouping(params))


def _port_params(ref):
    return bridge.lm_params(jax.device_get(ref["params"]))


def _batch(ref):
    return {k: bridge.tensor(v) for k, v in
            jax.device_get(ref["batch"]).items()}


def _leafwise(got, want, rel, what):
    """Each leaf of ``got`` within ``rel`` of its reference leaf's largest
    magnitude."""
    for i, (g, w) in enumerate(zip(tu.leaves(got), jax.tree.leaves(want))):
        w = np.asarray(w, np.float32)
        gap = float(np.abs(g.detach().float().numpy() - w).max())
        assert gap <= rel * float(np.abs(w).max()), (what, i, gap)


# ----------------------------------------------------------------- model --
def test_lm_loss_and_grad_match_reference(ref):
    cfg = conf.flash_test_config(2)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, ref["cfg"]), has_aux=True))
    (jtotal, jm), jg = vg(ref["params"], ref["batch"])
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         _port_params(ref))
    total, m = lm.lm_loss(params, _batch(ref), cfg)
    grads = torch.autograd.grad(total, tu.leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    assert int(m["tokens"]) == int(jm["tokens"]) == B * S
    assert float(m["moe_load_balance"]) == float(m["moe_z_loss"]) == 0.0
    _leafwise(tu.unflatten(tu.flatten(params)[1], list(grads)), jg, 5e-2,
              "grad")


def test_chunked_xent_matches_one_chunk_and_ignores_minus_one():
    g = torch.Generator().manual_seed(0)
    h = torch.randn((2, 64, 8), generator=g).requires_grad_(True)
    table = torch.randn((50, 8), generator=g).requires_grad_(True)
    y = torch.randint(0, 50, (2, 64), generator=g)
    y[0, :5] = -1
    nll, cnt = lm.chunked_xent(h, table, y, 16)
    nll1, cnt1 = lm.chunked_xent(h, table, y, 64)
    assert int(cnt) == int(cnt1) == 2 * 64 - 5
    torch.testing.assert_close(nll, nll1, rtol=1e-6, atol=0)
    logits = h @ table.T
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 50), y.reshape(-1), ignore_index=-1,
        reduction="sum")
    torch.testing.assert_close(nll, want, rtol=1e-5, atol=0)
    ga = torch.autograd.grad(nll, (h, table))
    gb = torch.autograd.grad(want, (h, table))
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("forward_forced", [True, False])
def test_recompute_keeps_the_forward_dispatch(ref, forward_forced):
    """A layer recomputed in backward takes the path its forward took,
    whatever the dispatch flags are when backward runs (on the card it
    runs on autograd's own thread, where they are unset): the checkpoint
    would otherwise recompute a different graph and raise."""
    cfg = conf.flash_test_config(2)
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         _port_params(ref))
    batch = _batch(ref)
    with ops.flash_fallback(forward_forced):
        total, _ = lm.lm_loss(params, batch, cfg)
    with ops.flash_fallback(not forward_forced):
        grads = torch.autograd.grad(total, tu.leaves(params))
    with ops.flash_fallback(forward_forced):
        total2, _ = lm.lm_loss(params, batch, cfg)
        want = torch.autograd.grad(total2, tu.leaves(params))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_layer_views_by_unbind_give_the_indexing_gradient(ref,
                                                         monkeypatch):
    """The stack's per-layer views come from one ``torch.unbind`` per
    stacked leaf; the gradient equals, bitwise, the one through per-layer
    indexing ``x[i]``."""
    cfg = conf.flash_test_config(2)
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         _port_params(ref))

    def grads():
        total, _ = lm.lm_loss(params, _batch(ref), cfg)
        return torch.autograd.grad(total, tu.leaves(params))

    by_unbind = grads()
    monkeypatch.setattr(blocks, "_layers", lambda tree, n: [
        tu.tree_map(lambda x: x[i], tree) for i in range(n)])
    for a, b in zip(by_unbind, grads()):
        assert torch.equal(a, b)


def test_stack_train_mode_refuses_in_loss_qdq(ref):
    """The stack's train mode refused the in-loss QDQ until
    ``reference_step`` was ported; now ``stack_fwd`` with per-layer codes
    (and ``lm_loss`` through it, codes 0/1 on the gpu ladder) matches the
    reference's, loss within rtol 1e-4 and gradients leaf by leaf within
    5e-2 of the leaf's largest magnitude (the tolerances above), and
    ``LMTask.loss`` passes the codes on only with a ``qdq_fn``."""
    from repro.core.precision import qdq as jqdq
    from repro_torch.core.precision import qdq
    cfg = conf.flash_test_config(2)
    codes = np.asarray([0, 1], np.int32)
    params, batch = _port_params(ref), _batch(ref)
    cp = tu.tree_map(lambda x: x.to(torch.bfloat16), params)

    def jloss(p):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        return jlm.lm_loss(p, ref["batch"], ref["cfg"],
                           codes=jnp.asarray(codes),
                           qdq_fn=lambda w, c: jqdq(w, c, "gpu"))[0]

    want, jgrad = jax.value_and_grad(jloss)(ref["params"])
    leaves, td = tu.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    p = tu.tree_map(lambda x: x.to(torch.bfloat16), tu.unflatten(td, wrt))
    got = lm.lm_loss(p, batch, cfg, codes=torch.from_numpy(codes),
                     qdq_fn=lambda w, c: qdq(w, c, "gpu"))[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    _leafwise(tu.unflatten(td, list(torch.autograd.grad(got, wrt))), jgrad,
              5e-2, "grad")
    # the codes reach the stack: tier 0 (fp16) rounds, unlike tier 2
    x = torch.randn((1, S, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32)[None]
    f = lambda c: blocks.stack_fwd(                         # noqa: E731
        cp["stack"], x, pos, cfg.stack, mode="train",
        codes=torch.tensor(c, dtype=torch.int32),
        qdq_fn=lambda w, k: qdq(w, k, "gpu"))[0]
    plain = blocks.stack_fwd(cp["stack"], x, pos, cfg.stack, mode="train")[0]
    assert torch.equal(f([2, 2]), plain)
    assert torch.equal(f([1, 1]), plain)      # bf16 weights: tier 1 no-op
    task = LMTask(cfg, device="cpu")
    ignored = task.loss(cp, {}, batch, torch.zeros(4, dtype=torch.int32),
                        None)[0]
    assert torch.equal(ignored, task.loss(cp, {}, batch, None, None)[0])


# -------------------------------------------------------------- grouping --
def test_lm_grouping_and_slab_match_reference(ref):
    cfg = conf.flash_test_config(2)
    params = _port_params(ref)
    grouping = LMTask(cfg, device="cpu").grouping(params)
    jg = ref["grouping"]
    assert grouping.num_layers == jg.num_layers == 4
    assert grouping.names == jg.names
    np.testing.assert_array_equal(grouping.counts.numpy(),
                                  np.asarray(jg.counts))
    for square in (False, True):
        np.testing.assert_allclose(grouping.sums(params, square).numpy(),
                                   np.asarray(jg.sums(ref["params"], square)),
                                   rtol=1e-5)
    vec = np.arange(4, dtype=np.float32) + 10
    got = grouping.broadcast(vec, params)
    want = jg.broadcast(jnp.asarray(vec), ref["params"])
    for a, b in zip(tu.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.broadcast_to(a, np.shape(b)),
                                      np.asarray(b))
    meta = tu.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                       params)
    view = slab_view(meta, LMTask(cfg, device="cpu").grouping(meta))
    jview = jslab_view(ref["params"], jg)
    assert view.rows == jview.rows
    np.testing.assert_array_equal(view.row_layer, jview.row_layer)


def test_memory_model_for_transformer_matches_reference():
    a = MemoryModel.for_transformer(1.345e8, 576, 30, opt_slots=1)
    b = JMemoryModel.for_transformer(1.345e8, 576, 30, opt_slots=1)
    for n in (2048, 8192):
        assert a.total(n, [1] * 32, "gpu") == b.total(n, [1] * 32, "gpu")


# ------------------------------------------------------------------ data --
def test_affine_orbit_matches_the_step_by_step_recurrence():
    rng = np.random.default_rng(3)
    V, n = 49152, 37
    x0, a, c = (rng.integers(lo, hi, (5, 1)) for lo, hi in
                ((0, V), (1, 8), (0, 8)))
    want = [x0[:, 0]]
    for _ in range(n - 1):
        want.append((a[:, 0] * want[-1] + c[:, 0]) % V)
    got = affine_orbit(*(torch.from_numpy(t) for t in (x0, a, c)), V, n)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def _affine_rows(tokens, labels, V):
    """Every row follows x_{t+1} = (a x_t + c) mod V for some a in [1, 8),
    c in [0, 8) (noise off), and labels are the tokens shifted by one."""
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
    seq = np.concatenate([tokens, labels[:, -1:]], axis=1).astype(np.int64)
    for row in seq:
        fits = [(a, c) for a in range(1, 8) for c in range(8)
                if np.array_equal((a * row[:-1] + c) % V, row[1:])]
        assert fits, row[:8]


def test_lm_stream_is_the_reference_construction():
    V, L = 512, 64
    port = LMTaskStream(V, L, 4, seed=7, noise=0.0).batch(3)
    assert port["tokens"].dtype == port["labels"].dtype == torch.int32
    assert tuple(port["tokens"].shape) == (4, L)
    _affine_rows(port["tokens"].numpy(), port["labels"].numpy(), V)
    jb = jax.device_get(JStream(V, L, 4, seed=7, noise=0.0).batch(3))
    _affine_rows(np.asarray(jb["tokens"]), np.asarray(jb["labels"]), V)
    noisy = LMTaskStream(V, 1024, 8, seed=7).batch(3)
    toks = noisy["tokens"].numpy()
    assert toks.min() >= 0 and toks.max() < V
    # a pure function of (seed, step): same batch again, another step differs
    again = LMTaskStream(V, 1024, 8, seed=7).batch(3)
    assert torch.equal(again["tokens"], noisy["tokens"])
    assert not torch.equal(LMTaskStream(V, 1024, 8, seed=7).batch(4)[
        "tokens"], noisy["tokens"])
    # about 5 % of the tokens are replaced at random
    clean = LMTaskStream(V, 1024, 8, seed=7, noise=0.0).batch(3)
    assert 0.03 < float((clean["tokens"] != noisy["tokens"]).float().mean()
                        ) < 0.07


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


# -------------------------------------------------------------- launcher --
def test_launcher_trains_on_the_cpu(capsys):
    tr = launch_train.main(["--arch", "smollm-135m", "--reduced",
                            "--steps", "3", "--rungs", "2", "--seq", "64",
                            "--ladder", "gpu", "--device", "cpu"],
                           t_ctrl=1, t_curv=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"loss"' in lines[0]      # log_every 10
    assert int(tr.state.control.step) == 3
    assert [r for _, r, _ in tr.scaler.history] == [2, 2]
    assert float(tr.state.control.lam.abs().sum()) > 0   # fisher at step 2


@pytest.mark.parametrize("flag", [["--ckpt", "/nonexistent"],
                                  ["--distributed"], ["--no-triaccel"]])
def test_launcher_unported_flags_raise(flag, capsys):
    """``--ckpt`` and ``--distributed`` are not ported and raise.
    ``--no-triaccel`` raised until ``reference_step`` was ported: it now
    trains the static bf16 baseline on the CPU, on the reference path,
    with every control off and the rung fixed."""
    if flag != ["--no-triaccel"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            launch_train.main(["--device", "cpu", "--steps", "1"] + flag)
        return
    tr = launch_train.main(["--arch", "smollm-135m", "--reduced", "--seq",
                            "64", "--rungs", "2", "--ladder", "gpu",
                            "--device", "cpu", "--steps", "2"] + flag)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"loss"' in lines[0]
    assert not tr.fused and tr.state.compute == ()
    assert not (tr.tac.dynamic_precision or tr.tac.enable_precision
                or tr.tac.enable_curvature or tr.tac.enable_batch)
    assert int(tr.state.control.step) == 2
    assert all(x["grads_finite"] == 1.0 for x in tr.metrics_log)
    assert tr.scaler.microbatch == 2 and tr.scaler.history == []


def test_trainer_runs_the_flash_config_on_the_cpu():
    """The main path's code at the 2-layer flash config: the attention
    goes through the autograd Function (plain versions here) and the
    fisher probe through the chunked path."""
    task = LMTask(conf.flash_test_config(2), device="cpu")
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, t_curv=2, b_curv=2,
                         curvature_method="fisher")
    tr = Trainer(task, tac, TrainerConfig(total_steps=3, seq_len=S,
                                          rungs=(2,), log_every=1),
                 device="cpu")
    log = tr.run(3)
    assert len(log) == 3
    assert all(np.isfinite(x["loss"]) and x["grads_finite"] == 1.0
               for x in log)
    assert all(x["tokens"] == 2 * S for x in log)
    assert float(tr.state.control.lam.abs().sum()) > 0
