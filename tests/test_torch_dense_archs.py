"""Port parity for the dense GQA architectures (stablelm-1.6b, minitron-4b,
gemma3-4b) against the reference package, by name, on the same numpy
inputs. Weights come from the reference's init (``bridge.lm_params``),
batches from the reference's ``LMTaskStream``.

  * The registry: ``ARCHITECTURES``, ``PAPER_ARCHS`` and
    ``list_architectures()`` equal the reference's; ``PENDING`` holds the
    two not ported yet (the two deepseek archs, mamba2-370m and
    recurrentgemma-2b are in ``PORTED``, the last two with their
    configs);
    ``list_tasks()`` the ported ones in the reference's order.
  * The full configs: the ``LMConfig`` fields equal the reference's, the
    parameter tree (``lm_init`` on ``meta``) has the reference's paths and
    shapes (``jax.eval_shape``) and parameter count (1,644,267,520 /
    4,190,309,376 / 3,879,925,248).
  * Each reduced config (the reference's ``reduced_config()``, naive
    attention; gemma3's window 8 with its ring caches), in bf16 as
    trained and served (torch and XLA round the bf16 projections and RoPE
    after sums taken in another order, one bf16 ulp, 2^-8 relative, here
    and there; the activations are bitwise, ``test_torch_activations``):
      - the loss within rtol 1e-4, the gradient leaf by leaf within 5e-2
        of the leaf's largest magnitude (B 2, S 32);
      - prefill logits within LOGIT_TOL = 0.02 absolute (about 4 % of
        their largest magnitude), the prefill caches' K and V within
        CACHE_TOL = 5e-2 of each leaf's largest magnitude, as the
        gradient (measured 0.86-2.4e-2: half the K and V elements of a
        first layer differ by a bf16 ulp of the projection, and the gaps
        grow with depth; gemma3's qk-norm makes its first K equal),
        positions equal;
      - prefill (P 12) scattered into decode caches of TOTAL 24 slots (8
        for gemma3's local layers) and 8 teacher-forced decode steps, so
        the local layers' rings wrap (slots 4-7 at step 0, 0-3 from step
        4): logits within LOGIT_TOL at every step, the caches' positions
        equal, K and V within CACHE_TOL;
      - one slab-resident fused step carried from the reference's state
        (sgdm, gpu ladder, every code bf16): as
        ``test_torch_lm_train.test_resident_lm_step_matches_reference``,
        the momentum leaf by leaf within 5e-2 of its largest magnitude,
        the master p_new - p_ref = -lr (m_new - m_ref) within 2^-21 (|p|
        + |p_new| + |p_ref|), codes, step and loss scale equal;
      - ``registry.get_task(arch, reduced=True, device="cpu")`` trains
        two steps through the ``Trainer``: finite losses, every gradient
        finite.
  * gemma3's reduced widths on the flash path (window 8 on the local
    layers) at S 256, B 2, through the reference's Pallas kernels in
    interpret mode and the port's plain kernel versions: loss, gradient
    and prefill logits within the tolerances above.

This file holds the shared checks (``check_*``), the registry and
full-config tests and stablelm-1.6b's; ``test_torch_dense_minitron.py``
and ``test_torch_dense_gemma3.py`` run the checks on the other two.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import gemma3_4b as jgemma  # noqa: E402
from repro.core.controller import init_control as jinit_control  # noqa
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.data.synthetic import LMTaskStream as JStream  # noqa: E402
from repro.kernels.layout import slab_view as jslab_view  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.optim.optimizers import sgdm as jsgdm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import gemma3_4b as gemma  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.kernels.layout import slab_view  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCHS = ["stablelm-1.6b", "minitron-4b", "gemma3-4b"]
PARAMS = {"stablelm-1.6b": 1_644_267_520, "minitron-4b": 4_190_309_376,
          "gemma3-4b": 3_879_925_248}
S, B = 32, 2
P, TOTAL, DECODE = 12, 24, 8
LOGIT_TOL = 0.02
CACHE_TOL = 5e-2
TAC = dict(ladder="gpu", t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=1e-5,
           alpha=0.05, tau_curv=50.0, curvature_method="fisher")
SCHED = (0.05, 2, 10)
CLIP = 5.0


def _np(x):
    """Port tensor or reference array -> f32/int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _rel_for(path, rel, loose):
    """``rel``, or the bound ``loose`` ({leaf key: rel}) gives a leaf whose
    path holds one of its keys."""
    return next((r for k, r in (loose or {}).items() if k in path), rel)


def _leafwise(got, want, rel, what, loose=None):
    """Each leaf of ``got`` within ``rel`` (or its ``loose`` bound) of its
    reference leaf's largest magnitude."""
    paths, got, want = tu.paths(got), tu.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = _np(w)
        gap = float(np.abs(_np(g) - w).max())
        bound = _rel_for(paths[i], rel, loose) * float(np.abs(w).max())
        assert gap <= bound, (what, paths[i], gap)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch thread: the reduced models are many small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_ref(arch):
    """The reference's reduced model of one arch: its task, params, aux
    state, a batch and grouping, beside the port's config."""
    cfg_j = jregistry.get_model_config(arch, reduced=True)
    cfg_t = registry.get_model_config(arch, reduced=True)
    task = JLMTask(cfg_j)
    wrapped, aux = task.init(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    batch = JStream(cfg_j.vocab_size, S, B, seed=5).batch(0)
    return dict(arch=arch, cfg=cfg_j, cfg_t=cfg_t, task=task, params=params,
                aux=aux, batch=batch, grouping=task.grouping(params))


def _port_params(params):
    return bridge.lm_params(jax.device_get(params))


def _port_batch(batch):
    return {k: bridge.tensor(v) for k, v in jax.device_get(batch).items()}


# ---------------------------------------------------------- registry ----
def test_registry_names_match_reference():
    assert registry.ARCHITECTURES == jregistry.ARCHITECTURES
    assert registry.PAPER_ARCHS == jregistry.PAPER_ARCHS
    assert registry.list_architectures() == jregistry.list_architectures()
    deepseek = {"deepseek-v2-lite-16b", "deepseek-v2-236b"}
    recurrent = {"mamba2-370m", "recurrentgemma-2b"}
    assert deepseek | recurrent <= set(registry.PORTED)
    assert set(registry.PENDING) == set(jregistry.ARCHITECTURES) - {
        "smollm-135m", *ARCHS, *deepseek, *recurrent}
    assert len(registry.PENDING) == 2
    for arch in recurrent:
        cfg = registry.get_model_config(arch)
        assert cfg.name == arch == jregistry.get_model_config(arch).name
        assert registry.get_model_config(arch, reduced=True).num_layers == \
            jregistry.get_model_config(arch, reduced=True).num_layers
    assert registry.list_tasks() == [a for a in jregistry.list_tasks()
                                     if a in registry.PORTED]
    for arch in registry.PENDING:
        with pytest.raises(NotImplementedError, match=arch):
            registry.get_model_config(arch)
    with pytest.raises(KeyError):
        registry.get_model_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_parameter_shapes_match_reference(arch):
    jc, tc = jregistry.get_model_config(arch), registry.get_model_config(arch)
    for f in ("name", "family", "vocab_size", "tie_embeddings",
              "scale_embed", "loss_chunk", "d_model", "num_layers"):
        assert getattr(tc, f) == getattr(jc, f), f
    js, ts = jc.stack, tc.stack
    for f in ("d_model", "d_ff", "act", "gated", "norm_eps", "remat"):
        assert getattr(ts, f) == getattr(js, f), f
    assert [([(b.kind, b.ffn, b.window) for b in defs], n)
            for defs, n in ts.segments] == \
        [([(b.kind, b.ffn, b.window) for b in defs], n)
         for defs, n in js.segments]
    for f in ("d_model", "num_heads", "num_kv_heads", "head_dim",
              "rope_theta", "qk_norm", "impl"):
        assert getattr(ts.attn, f) == getattr(js.attn, f), f
    want = jax.eval_shape(lambda: split_params(
        jlm.lm_init(jax.random.PRNGKey(0), jc))[0])
    got = lm.lm_init(None, tc, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat] == tu.paths(got)
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(got)]
    assert sum(t.numel() for t in tu.leaves(got)) == PARAMS[arch]
    if arch == "gemma3-4b":
        assert gemma.WINDOW == jgemma.WINDOW == 1024


# ------------------------------------------------- the reduced models ----
def check_loss_and_grad_match_reference(ref, loose=None):
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, ref["cfg"]), has_aux=True))
    (jtotal, jm), jg = vg(ref["params"], ref["batch"])
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         _port_params(ref["params"]))
    total, m = lm.lm_loss(params, _port_batch(ref["batch"]), ref["cfg_t"])
    grads = torch.autograd.grad(total, tu.leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    assert int(m["tokens"]) == int(jm["tokens"]) == B * S
    _leafwise(tu.unflatten(tu.flatten(params)[1], list(grads)), jg, 5e-2,
              "grad", loose)


def _bf16(tree):
    return jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16),
                        tree)


def _slot(pre, i):
    return tu.tree_map(lambda x: x[:, i:i + 1], pre)


def _caches_close(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            tu.leaves(got)):
        w, g = _np(w), _np(g)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "pos":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
        else:
            gap = float(np.abs(g - w).max())
            assert gap <= CACHE_TOL * float(np.abs(w).max()), (what, path,
                                                               gap)


def check_prefill_and_decode_past_the_ring_match_reference(ref):
    cfg_j, cfg_t = ref["cfg"], ref["cfg_t"]
    pj = _bf16(jax.device_get(ref["params"]))
    pt = bridge.lm_params(pj)
    V = cfg_j.vocab_size
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, (B, P)).astype(np.int32)
    lj, prej = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t},
                                                   cfg_j))(pj, toks)
    lt, pret = lm.lm_prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t)
    assert lt.dtype == torch.bfloat16 and tuple(lt.shape) == (B, V)
    gap = np.abs(_np(lt) - _np(lj)).max()
    assert gap <= LOGIT_TOL, f"prefill logits differ by {gap}"
    _caches_close(pret, prej, "prefill caches")

    cj = jlm.lm_init_cache(cfg_j, B, TOTAL)
    ct = lm.lm_init_cache(cfg_t, B, TOTAL)
    assert [tuple(x.shape) for x in tu.leaves(ct)] == \
        [tuple(x.shape) for x in jax.tree.leaves(cj)]
    for i in range(B):
        cj = jengine.scatter_prefill(cj, _slot(prej, i), i)
        ct = engine.scatter_prefill(ct, _slot(pret, i), i)
    decode_j = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i,
                                                             cfg_j))
    for step in range(DECODE):                  # teacher-forced decode
        tok = rng.integers(0, V, (B,)).astype(np.int32)
        idx = np.full((B,), P + step, np.int32)
        lj, cj = decode_j(pj, jnp.asarray(tok), cj, jnp.asarray(idx))
        lt, ct = lm.lm_decode_step(pt, torch.from_numpy(tok), ct,
                                   torch.from_numpy(idx), cfg_t)
        gap = np.abs(_np(lt) - _np(lj)).max()
        assert gap <= LOGIT_TOL, f"decode step {step}: logits differ by {gap}"
    _caches_close(ct, cj, "decode caches")
    if ref["arch"] == "gemma3-4b":             # the local rings wrapped
        ring = _np(ct["seg0"]["b0"]["mix"]["pos"])
        assert ring.shape[-1] == 8
        assert sorted(ring[0, 0].tolist()) == list(
            range(P + DECODE - 8, P + DECODE))


def check_resident_step_matches_reference(ref, loose=None):
    task, params, grouping = ref["task"], ref["params"], ref["grouping"]
    tac, opt = JTac(**TAC), jsgdm(0.9, 5e-4)
    view = jslab_view(params, grouping)
    L = grouping.num_layers
    ctl = jinit_control(L, tac)._replace(codes=jnp.ones(L, jnp.int32),
                                         loss_scale=jnp.float32(2.0 ** 15))
    comp = jts.init_compute(task, params, grouping, ctl, tac)
    jstate = jts.pack_state(view, jts.TrainState(
        params, ref["aux"], opt.init(params), ctl, comp), jnp.float32)
    step = jax.jit(jts.make_train_step(task, tac, opt, grouping,
                                       jwarmup(*SCHED), grad_clip=CLIP,
                                       resident_params=params))
    jnew, jm = jax.device_get(step(jstate, ref["batch"]))

    ptask = LMTask(ref["cfg_t"], device="cpu")
    like, _ = ptask.init(torch.Generator(), device="meta")
    pgroup = ptask.grouping(like)
    fn = make_train_step(ptask, TriAccelConfig(**TAC), sgdm(0.9, 5e-4),
                         pgroup, warmup_cosine(*SCHED), grad_clip=CLIP,
                         resident_params=like)
    pview = slab_view(like, pgroup)
    assert pview.rows == view.rows
    js = jax.device_get(jstate)
    state = bridge.train_state(js.params, js.aux_state, js.opt_state,
                               js.control._asdict(), js.compute)
    new, m = fn(state, _port_batch(ref["batch"]))

    assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) is True
    c, jc = new.control, jnew.control
    for k in ("step", "codes", "loss_scale", "good_steps", "ema_init"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    p0, p, jp = state.params.numpy(), _np(new.params), _np(jnew.params)
    mo, jmo = _np(new.opt_state["mu"]), _np(jnew.opt_state["mu"])
    for path, slot in zip(tu.paths(like), view.slots):   # leaf by leaf
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        bound = _rel_for(path, 5e-2, loose) * np.abs(jmo[rows]).max()
        assert np.abs(mo[rows] - jmo[rows]).max() <= bound, slot.shape
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr
    dev = np.abs((p - jp) + lr * (mo - jmo))
    assert np.all(dev <= 2.0 ** -21 * (np.abs(p0) + np.abs(p) + np.abs(jp)))


def check_registry_task_trains_on_the_cpu(ref):
    task = registry.get_task(ref["arch"], reduced=True, device="cpu")
    assert isinstance(task, LMTask) and task.cfg == ref["cfg_t"]
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, t_curv=40,
                         curvature_method="fisher")
    tr = Trainer(task, tac, TrainerConfig(total_steps=2, seq_len=S,
                                          rungs=(2,), log_every=1),
                 device="cpu")
    log = tr.run(2)
    assert len(log) == 2
    assert all(np.isfinite(x["loss"]) and x["grads_finite"] == 1.0
               for x in log)


# ------------------------------------------------ gemma3's flash path ----
def check_gemma3_flash_path():
    """gemma3's reduced widths at S 256 through the attention kernels: the
    reference's Pallas kernels (interpret mode), the port's plain
    versions, the local layers on the kernels' static window."""
    cfg_j = jgemma._make(1, 2, 64, 4, 2, 16, 128, 512, window=8,
                         impl="flash")
    cfg_t = gemma._make(1, 2, 64, 4, 2, 16, 128, 512, window=8,
                        impl="flash")
    params = split_params(jlm.lm_init(jax.random.PRNGKey(0), cfg_j))[0]
    batch = JStream(cfg_j.vocab_size, 256, B, seed=5).batch(0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg_j), has_aux=True))
    (jtotal, _), jg = vg(params, batch)
    pt = tu.tree_map(lambda x: x.requires_grad_(True), _port_params(params))
    total, _ = lm.lm_loss(pt, _port_batch(batch), cfg_t)
    grads = torch.autograd.grad(total, tu.leaves(pt))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    _leafwise(tu.unflatten(tu.flatten(pt)[1], list(grads)), jg, 5e-2,
              "grad")
    pj = _bf16(jax.device_get(params))
    toks = np.array(batch["tokens"])
    lj, _ = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t},
                                                cfg_j))(pj, toks)
    lt, _ = lm.lm_prefill(bridge.lm_params(pj),
                          {"tokens": torch.from_numpy(toks)}, cfg_t)
    gap = np.abs(_np(lt) - _np(lj)).max()
    assert gap <= LOGIT_TOL, f"prefill logits differ by {gap}"


# ------------------------------------------------------ stablelm-1.6b ----
# (minitron-4b and gemma3-4b run the same checks in their own files,
# test_torch_dense_minitron.py and test_torch_dense_gemma3.py, so xdist's
# loadfile workers share the reference's compiles)
@pytest.fixture(scope="module")
def ref():
    return make_ref("stablelm-1.6b")


def test_loss_and_grad_match_reference(ref):
    check_loss_and_grad_match_reference(ref)


def test_prefill_and_decode_match_reference(ref):
    check_prefill_and_decode_past_the_ring_match_reference(ref)


def test_resident_step_matches_reference(ref):
    check_resident_step_matches_reference(ref)


def test_registry_task_trains_on_the_cpu(ref):
    check_registry_task_trains_on_the_cpu(ref)
