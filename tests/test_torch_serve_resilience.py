"""Port parity for serving-side resilience: ``ServeSession``'s OOM recovery
(step-down through the repack, the (rung, tier) poison, tier demotion,
shedding with a bounded retry), the ``serve.step_oom`` / ``serve.latency``
fault sites and ``ServeEngine.compile_count``, against ``repro.serve`` and
``repro.resilience.soak``, on the CPU.

Model: the soaks' tiny LM (``soak.tiny_lm_task``: 2 layers, d 64, 4 heads,
kv 2, head_dim 16, d_ff 128, vocab 64, naive attention), prompt 4, cache
12, the soak's plan and ``ServeConfig`` unless a test says otherwise.

What must hold:
  * the port's ``serve_soak(device="cpu")`` report equals the reference's
    key by key;
  * one session of each package over the same weights
    (``bridge.lm_params``) under the soak's plan: the same statuses,
    retries, first-token steps and trails; greedy tokens equal, or first
    different only where the reference's top-2 logit margin is within
    LOGIT_TOL (``tests/test_torch_lm_serve.py``'s rule: bf16 rounded in
    another order flips near-ties);
  * the reference's unrecoverable case: every request fails after its
    retries, in both packages;
  * an allocator OOM in the middle of a decode (a layer raises
    ``torch.OutOfMemoryError`` before or after earlier layers wrote their
    cache rows) recovers bitwise as the same fault injected by
    ``serve.step_oom`` at that step: tokens and every cache leaf after the
    retried decode, and the trails; a failed decode leaves the invalid
    rows' cache entries bit-identical;
  * a cold session (no ``warm()``) counts the same paths in both packages;
  * ``release_failed_attempt`` frees a failed attempt's locals, and empties
    the allocator's cache only for a card.
"""
import contextlib
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.resilience import soak as jsoak  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.nn import attention as attn_lib  # noqa: E402
from repro_torch.resilience import soak  # noqa: E402
from repro_torch.resilience.faults import release_failed_attempt  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402

LOGIT_TOL = 0.02
P, TOTAL, VOCAB = 4, 12, 64
SOAK_CFG = dict(prompt_len=P, total_len=TOTAL, rungs=(1, 2), tiers=(0, 1),
                max_new_tokens=4, t_ctrl=4, auto_tier=False,
                max_request_retries=2, mem_cap_bytes=64e9)
PKGS = {"port": (res, ServeConfig), "reference": (jres, jsession.ServeConfig)}


@contextlib.contextmanager
def one_thread():
    """Thousands of tiny operations: one intra-op thread, restored after
    (module fixtures run outside the autouse fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    with one_thread():
        yield


def _soak_plan(pkg, seed=0):
    F = pkg.Fault
    return pkg.FaultPlan([
        F("serve.step_oom", step=4, rung=2, repeats=None),
        F("serve.step_oom", step=10, rung=1, tier=1, repeats=1),
        F("serve.latency", step=14, repeats=2, seconds=0.25)], seed=seed)


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=P).astype(np.int32)
            for _ in range(n)]


def _trail(sess, plan):
    return dict(steps=sess.steps, oom_events=list(sess.oom_events),
                poisoned=sorted(sess.mm.poisoned),
                rung_history=list(sess.rung_history),
                tier_history=list(sess.tier_history),
                fault_log=[(s, st) for s, st, _ in plan.log])


@pytest.fixture(scope="module")
def soaks():
    """The reference's ``serve_soak()`` once (its session kept) and the
    port's ``serve_soak(device="cpu")``."""
    kept = []

    class Kept(jsession.ServeSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setattr(jsession, "ServeSession", Kept)
        ref = jsoak.serve_soak()
        port = soak.serve_soak(device="cpu")
    return ref, port, kept[0]


def test_serve_soak_report_matches_reference(soaks):
    ref, port, _ = soaks
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key
    assert port["ok"] and port["statuses"] == ["done"]
    assert port["oom_events"] == [(4, 2, 1, "decode"), (10, 1, 1, "admit"),
                                  (12, 2, 0, "admit")]
    assert port["poisoned"] == [(1, 1), (2, 0), (2, 1)]
    assert port["rung_history"] == [(0, 1), (0, 2), (4, 1), (12, 2),
                                    (12, 1)]
    assert port["tier_history"] == [(0, 1), (10, 0)]
    assert port["fault_log"] == [
        ("serve.step_oom", 4), ("serve.step_oom", 10),
        ("serve.step_oom", 12), ("serve.latency", 14),
        ("serve.latency", 15)]


def _ref_params():
    """The weights the reference soak's session draws (its seed 0)."""
    wrapped, _ = jsoak.tiny_lm_task().init(jax.random.PRNGKey(0))
    return jax.device_get(split_params(wrapped)[0])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _margin_ok(pj, prompt, ref_tokens, pos, first_step, decode_steps,
               tier_at):
    """The reference's top-2 logit margin for generated token ``pos``,
    recomputed alone: its prefill at ``first_step``, then teacher-forced
    decodes on its own tokens, token d >= 1 from the decode at
    ``decode_steps[d - 1]``, each with the weights of the tier the session
    ran then."""
    cfg = jsoak.tiny_lm_task().cfg
    prefill = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t}, cfg))
    decode = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i, cfg))

    def params(step):
        return jengine.tier_params(pj, tier_at(step), "tpu")
    logits, pre = prefill(params(first_step), jnp.asarray(prompt[None]))
    caches = jengine.scatter_prefill(jlm.lm_init_cache(cfg, 1, TOTAL),
                                     pre, 0)
    for d in range(1, pos + 1):
        logits, caches = decode(params(decode_steps[d - 1]),
                                jnp.asarray([ref_tokens[d - 1]], jnp.int32),
                                caches, jnp.asarray([P + d - 1], jnp.int32))
    top = np.sort(_np(logits)[0])[-2:]
    return float(top[1] - top[0]) <= LOGIT_TOL


def test_serve_session_under_the_soak_plan_matches_reference(soaks):
    """The reference soak's own session against a port session over the
    same weights, plan, config and prompts."""
    _, _, sj = soaks
    pj = _ref_params()
    plan = _soak_plan(res)
    st = ServeSession(soak.tiny_lm_task(device="cpu"),
                      ServeConfig(**SOAK_CFG), params=bridge.lm_params(pj),
                      fault_plan=plan, device="cpu")
    st.warm()
    for p in _prompts():
        st.submit({"tokens": p})
    st.run(max_steps=400)
    assert _trail(st, plan) == _trail(sj, sj.fault_plan)
    assert st.decoded_tokens == sj.decoded_tokens
    assert st.lat.samples(1, 0) and max(st.lat.samples(1, 0)) >= 0.25
    retried = 0
    oom_decodes = {s for s, _, _, w in sj.oom_events if w == "decode"}

    def tier_at(step):
        return [t for s, t in sj.tier_history if s <= step][-1]
    for rid, rj in sj.results().items():
        rt = st.results()[rid]
        assert (rt.status, rt.retries, rt.first_token_step,
                rt.admitted_step, rt.finished_step) == \
            (rj.status, rj.retries, rj.first_token_step, rj.admitted_step,
             rj.finished_step), rid
        retried += rt.retries
        if rt.tokens == rj.tokens:
            continue
        pos = next(i for i, (a, b) in enumerate(zip(rt.tokens, rj.tokens))
                   if a != b)
        steps = [s for s in range(rj.first_token_step, sj.steps)
                 if s not in oom_decodes]
        assert _margin_ok(pj, rj.inputs["tokens"], rj.tokens, pos,
                          rj.first_token_step, steps, tier_at), (rid, pos)
    assert retried > 0           # the plan shed and replayed requests


@pytest.mark.parametrize("pkg", list(PKGS))
def test_serve_unrecoverable_oom_fails_requests_bounded(pkg):
    """The reference's case on both packages: one rung and one tier leave
    nowhere to step down, so each admission OOM sheds its request, and
    the retry budget turns the session's crash into status='failed'."""
    faults, Config = PKGS[pkg]
    plan = faults.FaultPlan([faults.Fault("serve.step_oom", step=0,
                                          repeats=None)])
    cfg = Config(prompt_len=P, total_len=TOTAL, rungs=(1,), tiers=(1,),
                 max_new_tokens=4, t_ctrl=4, auto_tier=False,
                 max_request_retries=1, mem_cap_bytes=64e9)
    if pkg == "port":
        sess = ServeSession(soak.tiny_lm_task(device="cpu"), cfg,
                            fault_plan=plan, device="cpu")
    else:
        sess = jsession.ServeSession(jsoak.tiny_lm_task(), cfg,
                                     fault_plan=plan)
    sess.warm()
    for p in _prompts(2):
        sess.submit({"tokens": p})
    sess.run(max_steps=60)
    reqs = sess.results().values()
    assert [r.status for r in reqs] == ["failed", "failed"]
    assert all(r.retries == 2 and r.tokens == [] for r in reqs)
    assert sess.oom_events and sess.decoded_tokens == 0
    assert sess.steps == 4 and sess.run()["failed"] == 2


# ------------------------------------------------ a real OOM mid-decode --
OOM_STEP = 2
OOM_CFG = dict(prompt_len=P, total_len=TOTAL, rungs=(2, 4), tiers=(1,),
               max_new_tokens=6, t_ctrl=4, auto_tier=False,
               mem_cap_bytes=64e9)


def _oom_session(plan=None):
    sess = ServeSession(soak.tiny_lm_task(device="cpu"),
                        ServeConfig(**OOM_CFG), fault_plan=plan,
                        device="cpu")
    sess.warm()
    for p in _prompts(4, seed=3):
        sess.submit({"tokens": p})
    return sess


def _cache_bits(sess):
    return [c.view(torch.int16).clone() if c.dtype == torch.bfloat16
            else c.clone() for c in tu.leaves(sess.caches)]


def _tokens(sess):
    return {rid: (r.status, list(r.tokens), r.slot, r.index, r.retries)
            for rid, r in sess.results().items()}


@pytest.mark.parametrize("layer,after", [(0, False), (1, False), (1, True)])
def test_real_oom_mid_decode_recovers_as_the_injected_fault(monkeypatch,
                                                            layer, after):
    """Four requests at rung 4; in the decode of step OOM_STEP, layer
    ``layer`` raises ``torch.OutOfMemoryError`` (``after`` its own cache
    write, else before it; earlier layers have written theirs). The
    session poisons (4, 1), sheds two requests, repacks the rest onto rung
    2 and retries the decode the next step: from there on it is bitwise
    the session whose OOM ``serve.step_oom`` injected at that step."""
    injected = _oom_session(res.FaultPlan([res.Fault(
        "serve.step_oom", step=OOM_STEP, rung=4, repeats=1)]))
    real = _oom_session()
    orig = attn_lib.gqa_decode
    armed = {"calls": None}

    def gqa_decode(*a, **kw):
        n = armed["calls"]
        if n is None:
            return orig(*a, **kw)
        armed["calls"] = n + 1
        if n == layer:
            armed["calls"] = None
            if after:
                orig(*a, **kw)
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return orig(*a, **kw)
    monkeypatch.setattr(attn_lib, "gqa_decode", gqa_decode)
    for step in range(OOM_STEP + 2):
        if step == OOM_STEP:
            armed["calls"] = 0
        real.step()
        injected.step()
        assert armed["calls"] is None
        if step < OOM_STEP:
            assert _tokens(real) == _tokens(injected)
    assert real.oom_events == injected.oom_events == [
        (OOM_STEP, 4, 1, "decode")]
    assert real.rung == injected.rung == 2
    assert (4, 1) in real.mm.poisoned
    # after the retried decode: tokens, slots and every cache leaf bitwise
    assert _tokens(real) == _tokens(injected)
    for a, b in zip(_cache_bits(real), _cache_bits(injected)):
        assert torch.equal(a, b)
    real.run()
    injected.run()
    assert _tokens(real) == _tokens(injected)
    assert (real.rung_history, real.tier_history, real.steps) == \
        (injected.rung_history, injected.tier_history, injected.steps)
    assert [r.status for r in real.results().values()] == ["done"] * 4
    assert sum(r.retries for r in real.results().values()) == 2


def test_failed_decode_leaves_invalid_rows_bit_identical(monkeypatch):
    """An engine decode with row 1 invalid that fails after every layer
    wrote its rows: row 1's cache entries are put back (the restore runs
    in ``finally``), so the failure leaves it as it was."""
    sess = _oom_session()
    sess.step()                    # admits all four: every row is live
    eng, caches = sess.engine, sess.caches
    before = _cache_bits(sess)
    orig = attn_lib.gqa_decode
    calls = []

    def gqa_decode(*a, **kw):
        out = orig(*a, **kw)
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return out
    monkeypatch.setattr(attn_lib, "gqa_decode", gqa_decode)
    valid = np.array([True, False, True, True])
    index = np.array([r.index for r in sess.slots], np.int32)
    with pytest.raises(torch.OutOfMemoryError):
        eng.decode(4, 1, caches, np.zeros(4, np.int32), index, valid)
    after = _cache_bits(sess)
    for a, b in zip(before, after):
        assert torch.equal(a[:, 1], b[:, 1])          # the invalid row
        assert not torch.equal(a[:, 0], b[:, 0])      # a live row written


def test_cold_session_compile_count_matches_reference():
    """No ``warm()``: each package counts a path the first time it runs,
    (decode | admit, rung, tier) and (repack, from, to); an injected OOM
    raises before its dispatch and counts nothing."""
    counts = {}
    for name, (faults, Config) in PKGS.items():
        plan = faults.FaultPlan([faults.Fault("serve.step_oom", step=2,
                                              rung=2, repeats=None)])
        cfg = Config(prompt_len=P, total_len=TOTAL, rungs=(1, 2), tiers=(1,),
                     max_new_tokens=4, t_ctrl=4, auto_tier=False,
                     mem_cap_bytes=64e9)
        sess = (ServeSession(soak.tiny_lm_task(device="cpu"), cfg,
                             fault_plan=plan, device="cpu")
                if name == "port" else
                jsession.ServeSession(jsoak.tiny_lm_task(), cfg,
                                      fault_plan=plan))
        assert sess.compile_count == 0
        for p in _prompts(3):
            sess.submit({"tokens": p})
        sess.run(max_steps=60)
        counts[name] = (sess.compile_count, list(sess.oom_events),
                        list(sess.rung_history))
    assert counts["port"] == counts["reference"]
    assert counts["port"][0] >= 5 and counts["port"][1]


@pytest.mark.parametrize("device,empties", [("cpu", 0), ("cuda", 1)])
def test_release_failed_attempt_frees_the_attempt(monkeypatch, device,
                                                  empties):
    """The locals of a failed attempt's frames (its activations) die before
    recovery allocates; the allocator's cache is emptied for a card only
    (counted through a stand-in: this host has none)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: calls.append(1))
    held = []

    def attempt():
        acts = torch.ones(4096)
        held.append(weakref.ref(acts))
        raise res.simulated_oom("serve.decode", 0)

    try:
        attempt()
    except Exception as e:  # noqa: BLE001 — the test's own raise
        assert held[0]() is not None
        release_failed_attempt(e, device)
        assert held[0]() is None
    assert len(calls) == empties
