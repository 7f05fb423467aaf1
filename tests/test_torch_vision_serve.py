"""Port parity for cache-free vision serving: ``VisionTask.infer``,
``make_infer_fn``, ``ServeEngine.infer`` / ``warm`` / ``measured_bytes``
and ``ServeSession`` over ResNet-18, against ``repro`` on the CPU.

ResNet-18 at batch <= 4 with the reference's weights (``bridge.tree``) and
BatchNorm statistics that two train-mode forwards of the reference moved
off their init (inference mode then normalizes by real statistics).

What must hold:
  * ``infer``'s logits (f32) equal the reference's within TOL[tier] of the
    largest logit magnitude on both ladders: tier 2 (f32) 1e-5 (the two
    f32 forwards sum in other orders; 5.9e-7 seen); tiers 1 and 0 (a bf16
    weight set, bitwise the reference's ``tier_params``, and bf16
    activations) 2e-2 (torch and XLA round each bf16 layer output after
    sums taken in another order; 5.5e-3 seen, one bf16 ulp of the largest
    logit is 3.9e-3 of it); the argmax equal wherever the
    reference's top-2 margin exceeds that bound; the images are cast to
    the weights' dtype and the running statistics are left untouched;
  * a ``ServeSession`` (rungs 2/4, tiers 1/2) serves every request with
    ``result`` in [0, 10) and runs no path after ``warm()``; ``warm`` runs
    the ("infer", rung, tier) paths the reference compiles, and no others;
  * an injected ``serve.step_oom`` at the "infer" site sheds the batch
    (its requests hold no slot), steps the rung down and retries: the same
    trail as the reference's session (oom_events, poisoned pairs, rung
    history, statuses, retries) and the same predictions;
  * the base ``TrainTask``'s serving hooks raise "does not ..." by name,
    as the reference's do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.data.synthetic import CIFARLikeStream as JStream  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.models.vision import vision_apply as jvision_apply  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSession as JServeSession  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import task as jtask  # noqa: E402
from repro.train.serve import make_infer_fn as jmake_infer_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.smollm_135m import flash_test_config  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import task as ttask  # noqa: E402
from repro_torch.train.serve import make_infer_fn  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

TOL = {2: 1e-5, 1: 2e-2, 0: 2e-2}


@pytest.fixture(scope="module")
def ref():
    """The reference's ResNet-18, its BN statistics after two train-mode
    forwards, and eight eval images."""
    cfg = JVisionConfig("resnet18")
    task = jtask.VisionTask(cfg)
    wrapped, aux = jax.jit(task.init)(jax.random.PRNGKey(0))
    params = split_params(wrapped)[0]
    step = jax.jit(lambda p, a, x: jvision_apply(p, a, x, True, cfg)[1])
    for i in range(2):
        aux = step(params, aux, JStream(global_batch=8, seed=i).batch(0)[
            "images"])
    images = JStream(global_batch=8, seed=3, train=False).batch(0)["images"]
    return dict(task=task, params=jax.device_get(params),
                aux=jax.device_get(aux), images=np.asarray(images))


def _port(ref):
    return (ttask.VisionTask(VisionConfig("resnet18"), device="cpu"),
            bridge.tree(ref["params"]), bridge.tree(ref["aux"]))


@pytest.mark.parametrize("ladder", ["gpu", "tpu"])
def test_infer_matches_reference_at_every_tier(ref, ladder):
    task, params, aux = _port(ref)
    aux0 = tu.tree_map(lambda a: a.clone(), aux)
    jinfer = jax.jit(jmake_infer_fn(ref["task"]))
    infer = make_infer_fn(task)
    x = ref["images"][:4]
    for tier in (2, 1, 0):
        jp = jengine.tier_params(ref["params"], tier, ladder)
        pt = engine.tier_params(params, tier, ladder)
        for a, b in zip(jax.tree.leaves(jax.device_get(jp)), tu.leaves(pt)):
            a = np.asarray(a)
            assert (a.view(np.uint8) == b.view(torch.uint8).numpy()).all()
        jpred, jlogits = jinfer(jp, ref["aux"], {"images": jnp.asarray(x)})
        pred, logits = infer(pt, aux, {"images": torch.from_numpy(x)})
        assert logits.dtype == torch.float32 and pred.dtype == torch.int32
        assert tuple(logits.shape) == (4, 10)
        jl = np.asarray(jlogits)
        scale = np.abs(jl).max()
        gap = np.abs(logits.numpy() - jl).max()
        assert gap <= TOL[tier] * scale, (tier, gap / scale)
        top = np.sort(jl, axis=-1)
        sure = top[:, -1] - top[:, -2] > TOL[tier] * scale
        assert (pred.numpy() == np.asarray(jpred))[sure].all(), tier
    for a, b in zip(tu.leaves(aux), tu.leaves(aux0)):
        assert torch.equal(a, b)                    # stats untouched


def test_infer_casts_images_to_the_weights_dtype(ref, monkeypatch):
    task, params, aux = _port(ref)
    seen = []
    orig = ttask.vision_apply

    def spy(p, a, images, train, cfg):
        seen.append((images.dtype, train))
        return orig(p, a, images, train, cfg)
    monkeypatch.setattr(ttask, "vision_apply", spy)
    x = torch.from_numpy(ref["images"][:2])
    for tier, dt in ((2, torch.float32), (1, torch.bfloat16),
                     (0, torch.bfloat16)):
        out = task.infer(engine.tier_params(params, tier, "gpu"), aux,
                         {"images": x})
        assert out.dtype == torch.float32
        assert seen[-1] == (dt, False)


def _images(ref, n, seed=0):
    x = ref["images"]
    rng = np.random.default_rng(seed)
    return [x[i % len(x)] + 0.01 * rng.standard_normal(x.shape[1:]).astype(
        np.float32) for i in range(n)]


def test_session_serves_every_request(ref):
    task, params, aux = _port(ref)
    cfg = dict(rungs=(2, 4), tiers=(1, 2), ladder="gpu", t_ctrl=1)
    sess = ServeSession(task, ServeConfig(**cfg), params=params,
                        aux_state=aux, device="cpu")
    assert sess.caches is None and not sess.chunked
    warmed = sess.warm()
    eng = sess.engine
    assert eng._seen == {("infer", r, t) for r in (2, 4) for t in (1, 2)}
    assert warmed == 4 and eng.runs["infer"] == 4
    assert eng.runs["decode"] == eng.runs["admit"] == eng.runs["repack"] == 0
    assert eng.measured_bytes(2, 1) is None          # measured on a card
    jsess = JServeSession(ref["task"], JServeConfig(**cfg),
                          params=ref["params"], aux_state=ref["aux"])
    jsess.warm()
    assert set(jsess.engine._exe) == eng._seen
    for x in _images(ref, 7):
        sess.submit({"images": x})
    rep = sess.run()
    assert rep["compile_count"] == warmed and rep["warm_s"] == 0.0
    reqs = sess.results()
    assert len(reqs) == 7 and all(r.status == "done" for r in reqs.values())
    assert all(0 <= r.result < 10 for r in reqs.values())


@pytest.mark.parametrize("rung", [4, 2])
def test_injected_infer_oom_sheds_and_retries_as_the_reference(ref, rung):
    """``serve.step_oom`` at step 0 on rung 4 (a step-down to 2, the batch
    shed and served again) or on rung 2 (the smallest: tier demotion)."""
    task, params, aux = _port(ref)
    cfg = dict(rungs=(2, 4), tiers=(1, 2), ladder="gpu", t_ctrl=1,
               auto_tier=False, max_request_retries=2)
    trails = []
    images = _images(ref, 6, seed=1)
    for mod, sess in (
            (jres, JServeSession(ref["task"], JServeConfig(**cfg),
                                 params=ref["params"], aux_state=ref["aux"])),
            (res, ServeSession(task, ServeConfig(**cfg), params=params,
                               aux_state=aux, device="cpu"))):
        plan = mod.FaultPlan([mod.Fault("serve.step_oom", step=0,
                                        rung=rung)])
        sess.fault_plan = plan
        if rung == 2:
            sess.set_tier(2, lock=False)
        sess.warm()
        for x in images:
            sess.submit({"images": x})
        sess.run(max_steps=50)
        trails.append(dict(
            steps=sess.steps, oom_events=list(sess.oom_events),
            poisoned=sorted(sess.mm.poisoned),
            rung_history=list(sess.rung_history),
            tier_history=list(sess.tier_history),
            log=[(s, st) for s, st, _ in plan.log],
            reqs=[(r.status, r.retries, r.admitted_step, r.result)
                  for r in sess.results().values()]))
    assert trails[1] == trails[0]
    assert [w for *_, w in trails[1]["oom_events"]] == ["infer"]
    assert any(r[1] == 1 for r in trails[1]["reqs"])       # shed, retried
    assert all(r[0] == "done" for r in trails[1]["reqs"])


@pytest.mark.parametrize("hook,args", [
    ("init_cache", ({"images": None}, 8)), ("prefill", (None, None)),
    ("decode", (None, None, None, 0)), ("infer", (None, None, None))])
def test_base_task_serving_hooks_raise_by_name(ref, hook, args):
    """The hooks a task lacks raise as the reference's base does: the
    vision task has no cache, no prefill, no decode; the LM no infer."""
    vision = ttask.VisionTask(VisionConfig("resnet18"), device="cpu")
    lm = ttask.LMTask(flash_test_config(2), device="cpu")
    port = lm if hook == "infer" else vision
    jref = (jtask.LMTask(jconf._make(2, 64, 4, 2, 16, 128, 512,
                                     impl="flash"))
            if hook == "infer" else ref["task"])
    assert isinstance(port, ttask.TrainTask)
    msgs = []
    for t in (port, jref):
        with pytest.raises(NotImplementedError) as e:
            getattr(t, hook)(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith(type(port).__name__ + " ")
    assert port.serves_tokens == jref.serves_tokens == (hook == "infer")
