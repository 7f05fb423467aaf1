"""Port parity for chunked prefill and SLO serving: ``ServeEngine.chunk_admit``
and ``ServeSession`` with ``prefill_chunk`` and ``schedule="slo"``, against
``repro.serve`` with the reference's weights (``bridge.lm_params``), on the
CPU with one torch thread.

Model: ``tests/test_torch_lm_serve.py``'s ``_cfgs()`` pair (smollm-135m's
shape at 2 layers, d 64, 4 heads, kv 2, head_dim 16, d_ff 128, vocab 512,
flash path: the reference's Pallas kernels in interpret mode, the port's
plain versions); caches of 24 or 32 positions, which the ragged decode
kernel tiles, so every chunk token goes through ``flash_decode``.

What must hold:
  * a chunked session's greedy tokens (chunk 3: ragged on an 8-token
    prompt; chunk 8: an exact fit) equal the reference's chunked session's
    and the port's own whole-prompt session's; where a token differs, the
    reference's top-2 logit margin at that position (its decode hook,
    teacher-forced) lies within LOGIT_TOL = 0.02, the bound of
    ``tests/test_torch_lm_serve.py``: bf16 rounded in another order, and
    the prefill's sums against the decode's, flip near-ties;
  * ``chunk_admit`` writes the slot's cache rows in place (the same
    tensors come back; nothing outside the slot's row changes), a fresh
    first chunk clears the row, and the rows equal the reference's chunk
    executable's: positions exactly, K/V within KV_TOL = 2^-6 (a bf16 ulp
    at the projections' magnitudes, < 2);
  * a row still prefilling stays bit-identical through a batched decode;
  * chunked admission never stalls the in-flight decodes, variable-length
    prompts validate, the latency ceiling pins the floor rung (the
    reference's own tests (e), (f) and the validation test on the port);
  * a ``drive`` replay of a Poisson trace after ``warm()`` runs no new
    path and reports ``warm_s == 0.0``, every request done or rejected;
    the steps, tokens, rung history and statuses equal the reference's;
  * an injected ``serve.step_oom`` at a chunk gives the reference's trail
    (oom_events with site "chunk", poisoned pairs, rung and tier history,
    fault log, statuses, retries).
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve import engine, traffic  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_lm_serve import _cfgs, _np, _params  # noqa: E402

LOGIT_TOL = 0.02
KV_TOL = 2.0 ** -6
VOCAB = 512


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    pj = _params()
    return pj, bridge.lm_params(pj)


def _prompts(n, length, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (length,)).astype(np.int32)
            for _ in range(n)]


def _sessions(weights, **kw):
    """A reference and a port session with the same config and weights."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = weights
    sj = jsession.ServeSession(JLMTask(cfg_j), jsession.ServeConfig(**kw),
                               params=pj)
    st = ServeSession(LMTask(cfg_t, device="cpu"), ServeConfig(**kw),
                      params=pt, device="cpu")
    return sj, st


def _serve(sess, prompts, steps_between=0, **submit):
    n = sess.warm()
    for p in prompts:
        sess.submit({"tokens": p}, **submit)
        for _ in range(steps_between):
            sess.step()
    sess.run(max_steps=200)
    assert sess.compile_count == n                 # no path after warm()
    return {rid: list(r.tokens) for rid, r in sess.results().items()}


def _ref_margins(pj, prompt, tokens, total):
    """The reference's top-2 logit margin at each generated position of
    ``tokens``: its decode hook at tier 1 (bf16), teacher-forced over the
    prompt and then over ``tokens``."""
    cfg_j, _ = _cfgs()
    params = jengine.tier_params(pj, 1, "tpu")
    dec = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i, cfg_j))
    caches = jlm.lm_init_cache(cfg_j, 1, total)
    seq = list(prompt) + list(tokens)
    margins = []
    for i, t in enumerate(seq[:-1]):
        logits, caches = dec(params, jnp.asarray([t], jnp.int32), caches,
                             jnp.asarray([i], jnp.int32))
        if i >= len(prompt) - 1:
            top = np.sort(_np(logits)[0])[-2:]
            margins.append(float(top[1] - top[0]))
    return margins


def _same_or_near_tie(got, want, margins, what):
    if got == want:
        return
    pos = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    assert margins[pos] <= LOGIT_TOL, (what, pos, margins[pos])


@pytest.mark.parametrize("chunk", [3, 8])
def test_chunked_tokens_match_reference_and_whole_prompt(weights, chunk):
    """Two 8-token prompts, the second after two steps (rungs 1 -> 2),
    through a chunked session of each package and the port's
    whole-prompt session."""
    kw = dict(prompt_len=8, total_len=24, rungs=(1, 2), tiers=(1,),
              ladder="tpu", max_new_tokens=6, t_ctrl=4)
    prompts = _prompts(2, 8)
    sj, st = _sessions(weights, prefill_chunk=chunk, **kw)
    whole = ServeSession(LMTask(_cfgs()[1], device="cpu"), ServeConfig(**kw),
                         params=weights[1], device="cpu")
    assert st.chunked and sj.chunked and not whole.chunked
    want = _serve(sj, prompts, steps_between=2)
    got = _serve(st, prompts, steps_between=2)
    base = _serve(whole, prompts, steps_between=2)
    assert st.engine.runs["admit"] == 0 and whole.engine.runs["chunk"] == 0
    assert st.engine.runs["chunk"] == 2 * -(-8 // chunk) + len(kw["rungs"])
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == kw["max_new_tokens"]
        m = _ref_margins(weights[0], prompts[rid], toks, kw["total_len"])
        _same_or_near_tie(got[rid], toks, m, ("reference", rid))
        _same_or_near_tie(base[rid], toks, m, ("whole-prompt", rid))
    assert [r.first_token_step for r in st.results().values()] == \
        [r.first_token_step for r in sj.results().values()]


def _engine(weights, rungs=(2,), chunk=3, total=24):
    _, cfg_t = _cfgs()
    return engine.ServeEngine(LMTask(cfg_t, device="cpu"), weights[1],
                              total_len=total, prompt_len=8, rungs=rungs,
                              tiers=(1,), prefill_chunk=chunk)


def _row(caches, slot):
    m = caches["seg0"]["b0"]["mix"]
    return {k: v[:, slot].clone() for k, v in m.items()}


def test_chunk_admit_writes_the_slot_rows_in_place(weights):
    """Chunks of 3 into slot 1 of a rung-2 cache whose slot 0 holds a
    request: the caches come back as the same tensors, slot 0 untouched,
    slot 1's positions [0, 6) written and the rest empty; a fresh chunk
    on a used row clears it first; the rows equal the reference's."""
    eng = _engine(weights)
    caches = eng.init_caches(2)
    leaves = {k: v for k, v in caches["seg0"]["b0"]["mix"].items()}
    a, b = _prompts(2, 8, seed=5)
    for f in range(0, 8, 3):                         # slot 0: a whole prompt
        _, caches = eng.chunk_admit(2, 1, caches, 0, a[f:f + 3], f,
                                    min(3, 8 - f), f == 0)
    row0 = _row(caches, 0)
    for f in (0, 3):
        tok, out = eng.chunk_admit(2, 1, caches, 1, b[f:f + 3], f, 3, f == 0)
        assert out is caches
    assert all(caches["seg0"]["b0"]["mix"][k] is v for k, v in leaves.items())
    for k, v in _row(caches, 0).items():
        assert torch.equal(v, row0[k]), k
    pos = caches["seg0"]["b0"]["mix"]["pos"][:, 1]
    assert pos[:, :6].tolist() == [list(range(6))] * 2
    assert (pos[:, 6:] == -1).all()
    kv = caches["seg0"]["b0"]["mix"]["k"][:, 1]
    assert (kv[:, :6] != 0).any(dim=(2, 3)).all() and (kv[:, 6:] == 0).all()
    assert eng.chunk_tokens == 8 + 6 and eng.runs["chunk"] == 5

    # the reference's chunk executable on the same inputs
    cfg_j, _ = _cfgs()
    jeng = jengine.ServeEngine(JLMTask(cfg_j), weights[0], total_len=24,
                               prompt_len=8, rungs=(2,), tiers=(1,),
                               prefill_chunk=3)
    jc = jeng.init_caches(2)
    for f in range(0, 8, 3):
        _, jc = jeng.chunk_admit(2, 1, jc, 0, np.pad(a[f:f + 3], (
            0, 3 - len(a[f:f + 3]))), f, min(3, 8 - f), f == 0)
    for f in (0, 3):
        jtok, jc = jeng.chunk_admit(2, 1, jc, 1, b[f:f + 3], f, 3, f == 0)
    jm = jax.device_get(jc["seg0"]["b0"]["mix"])
    got = caches["seg0"]["b0"]["mix"]
    assert (np.asarray(jm["pos"]) == got["pos"].numpy()).all()
    for k in ("k", "v"):
        gap = np.abs(_np(got[k]) - _np(jm[k])).max()
        assert gap <= KV_TOL, (k, gap)

    # a fresh first chunk on a used row: the old occupant's state is gone
    _, caches = eng.chunk_admit(2, 1, caches, 1, a[:2], 0, 2, True)
    pos = caches["seg0"]["b0"]["mix"]["pos"][:, 1]
    assert pos[:, :2].tolist() == [[0, 1]] * 2 and (pos[:, 2:] == -1).all()
    assert (caches["seg0"]["b0"]["mix"]["v"][:, 1, 2:] == 0).all()


def test_prefilling_row_is_bit_identical_through_decode(weights):
    """Slot 0 decodes while slot 1 is part way through its chunks (its
    index 0, invalid): the batched decode writes nothing of slot 1."""
    eng = _engine(weights)
    caches = eng.init_caches(2)
    a, b = _prompts(2, 8, seed=6)
    for f in range(0, 8, 3):
        tok, caches = eng.chunk_admit(2, 1, caches, 0, a[f:f + 3], f,
                                      min(3, 8 - f), f == 0)
    _, caches = eng.chunk_admit(2, 1, caches, 1, b[:3], 0, 3, True)
    before = _row(caches, 1)
    out, caches = eng.decode(2, 1, caches, np.array([int(tok), 0]),
                             np.array([8, 0]), np.array([True, False]))
    for k, v in _row(caches, 1).items():
        assert torch.equal(v, before[k]), k
    assert int(caches["seg0"]["b0"]["mix"]["pos"][0, 0, 8]) == 8


def test_chunked_admission_never_stalls_decode(weights):
    """The reference's test (e) on the port: a 16-token prompt's 8 chunks
    land while the active slot keeps producing a token every step."""
    _, cfg_t = _cfgs()
    sess = ServeSession(LMTask(cfg_t, device="cpu"), ServeConfig(
        prompt_len=8, total_len=32, rungs=(2,), tiers=(1,), max_new_tokens=8,
        t_ctrl=4, prefill_chunk=2, schedule="slo"), params=weights[1],
        device="cpu")
    sess.warm()
    prompt = _prompts(1, 8, seed=3)[0]
    a = sess.submit({"tokens": prompt[:5]})
    for _ in range(4):
        sess.step()
    ra = sess.results()[a]
    assert ra.status == "active" and len(ra.tokens) >= 1
    b = sess.submit({"tokens": np.concatenate([prompt, prompt])})
    grew = []
    for _ in range(3):
        before = len(ra.tokens)
        sess.step()
        grew.append(len(ra.tokens) > before or ra.done)
        assert sess.results()[b].status == "prefilling"
    assert all(grew), "active slot stalled while chunks were landing"
    sess.run(max_steps=80)
    assert all(r.done for r in sess.results().values())


def test_variable_length_validation(weights):
    """The reference's validation test on the port."""
    _, cfg_t = _cfgs()
    task = LMTask(cfg_t, device="cpu")
    fixed = ServeSession(task, ServeConfig(prompt_len=8, total_len=16,
                                           rungs=(1,)), params=weights[1],
                         device="cpu")
    with pytest.raises(ValueError):                  # not prompt_len
        fixed.submit({"tokens": np.zeros((5,), np.int32)})
    chunked = ServeSession(task, ServeConfig(prompt_len=8, total_len=16,
                                             rungs=(1,), prefill_chunk=4),
                           params=weights[1], device="cpu")
    chunked.submit({"tokens": np.zeros((5,), np.int32)}, max_new_tokens=4)
    with pytest.raises(ValueError):                  # exceeds total_len
        chunked.submit({"tokens": np.zeros((14,), np.int32)},
                       max_new_tokens=8)
    with pytest.raises(ValueError):
        chunked.submit({"tokens": np.zeros((0,), np.int32)})
    with pytest.raises(ValueError):
        chunked.submit({"tokens": np.zeros((4,), np.int32)},
                       max_new_tokens=0)
    with pytest.raises(ValueError):
        ServeSession(task, ServeConfig(schedule="lifo"), params=weights[1],
                     device="cpu")


def test_latency_ceiling_pins_the_floor_rung(weights):
    """The reference's test (f) on the port: an impossible class budget
    (1 us a step) keeps a load that wants rung 2 at rung 1."""
    _, cfg_t = _cfgs()
    sess = ServeSession(LMTask(cfg_t, device="cpu"), ServeConfig(
        prompt_len=8, total_len=16, rungs=(1, 2), tiers=(1,),
        max_new_tokens=3, t_ctrl=1, schedule="slo",
        latency_slo_ms={0: 1e-3}), params=weights[1], device="cpu")
    sess.warm()
    toks = _prompts(4, 8, seed=5)
    sess.submit({"tokens": toks[0]}, priority=0)
    sess.step()
    sess.step()
    assert sess.lat.samples(1, 1), "no latency measured"
    for t in toks[1:]:
        sess.submit({"tokens": t}, priority=0)
    sess.run(max_steps=60)
    assert all(r.done for r in sess.results().values())
    assert {r for _, r in sess.rung_history} == {1}, sess.rung_history


def _classes(mod):
    return [mod.TrafficClass(priority=0, rate=0.15, prompt_lens=(4, 8),
                             new_tokens=(3, 4), deadline_ms=60_000.0),
            mod.TrafficClass(priority=2, rate=0.1, prompt_lens=(6, 12),
                             new_tokens=(3,), burst_every=8, burst_size=2)]


def test_drive_replays_a_trace_with_no_path_after_warm(weights):
    """The reference's traffic soak (h) on the port, beside the
    reference's on the same trace and weights."""
    kw = dict(prompt_len=8, total_len=32, rungs=(1, 2), tiers=(1,),
              t_ctrl=4, prefill_chunk=4, schedule="slo",
              latency_slo_ms={0: 60_000.0})
    sj, st = _sessions(weights, **kw)
    reps = {}
    for name, sess, mod in (("reference", sj, jtraffic),
                            ("port", st, traffic)):
        warmed = sess.warm()
        trace = mod.poisson_trace(_classes(mod), 20, seed=11)
        rep = mod.drive(sess, trace, vocab=VOCAB, seed=11)
        assert rep["compile_count"] == warmed        # no path after warm()
        assert rep["warm_s"] == 0.0 and rep["tok_s"] > 0
        done = [r for r in sess.results().values() if r.done]
        assert len(done) + rep["rejected"] == rep["offered"] and done
        assert set(rep["classes"]) <= {"0", "2"}
        c0 = rep["classes"].get("0")
        if c0 is not None and c0["deadline_hit_rate"] is not None:
            assert c0["deadline_hit_rate"] == 1.0    # 60 s budget
        reps[name] = (rep, [(r.status, r.priority, len(r.tokens),
                             r.first_token_step) for r in
                            sess.results().values()])
    (rp, sp), (rr, sr) = reps["port"], reps["reference"]
    for k in ("steps", "offered", "decoded_tokens", "rung_history",
              "rejected"):
        assert rp[k] == rr[k], k
    assert sp == sr


def _trail(sess, plan):
    return dict(steps=sess.steps, oom_events=list(sess.oom_events),
                poisoned=sorted(sess.mm.poisoned),
                rung_history=list(sess.rung_history),
                tier_history=list(sess.tier_history),
                fault_log=[(s, st) for s, st, _ in plan.log],
                requests=[(r.status, r.retries, r.first_token_step,
                           r.admitted_step, len(r.tokens))
                          for r in sess.results().values()])


@pytest.mark.parametrize("rung", [2, 1])
def test_injected_oom_at_a_chunk_matches_reference(weights, rung):
    """``serve.step_oom`` at step 1 on rung 2 (a step-down, the youngest
    shed) or on rung 1 (a tier demotion) fires at the first chunk of that
    step: both packages take the same recovery."""
    kw = dict(prompt_len=8, total_len=24, rungs=(1, 2), tiers=(0, 1),
              ladder="tpu", max_new_tokens=4, t_ctrl=4, auto_tier=False,
              prefill_chunk=3, max_request_retries=2)
    if rung == 1:
        kw["rungs"] = (1,)
    sj, st = _sessions(weights, **kw)
    trails = []
    for sess, mod in ((sj, jres), (st, res)):
        plan = mod.FaultPlan([mod.Fault("serve.step_oom", step=1,
                                        rung=rung)])
        sess.fault_plan = plan
        sess.warm()
        for p in _prompts(3, 8, seed=9)[:2] + [_prompts(1, 5)[0]]:
            sess.submit({"tokens": p})
        sess.run(max_steps=200)
        trails.append(_trail(sess, plan))
    assert trails[1] == trails[0]
    assert [w for *_, w in trails[1]["oom_events"]] == ["chunk"]
    assert all(s == "done" for s, *_ in trails[1]["requests"])
