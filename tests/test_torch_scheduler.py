"""Port parity for SLO-aware admission: ``serve.scheduler.Scheduler`` /
``SchedulerConfig`` and ``serve.traffic`` (``poisson_trace``,
``make_prompt``, ``class_report``) against ``repro.serve``, pure CPU.

Both packages' schedulers take the same ``submit`` / ``pop`` / ``requeue``
sequences, with ``now`` injected and every request's ``submit_time`` set
to the same value (``submit`` stamps the wall clock), and must agree
exactly: the rids popped in the same order, the same statuses, priorities,
deadlines and ``rejected`` lists, queue depths by class. The traffic
helpers are plain numpy: the same ``Arrival``s for the same classes and
seed, the same prompts, and the same per-class report over the same
finished requests, compared with ``==`` (no tolerance).
"""
import dataclasses

import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro.serve import traffic as jtraffic
from repro.serve.batching import Request as JRequest
from repro_torch.serve import scheduler as sched
from repro_torch.serve import traffic
from repro_torch.serve.batching import Request

PKGS = {"port": sched, "reference": jsched}
T0 = 1000.0


def _state(s):
    """A scheduler's observable state, as plain values."""
    q = sorted((r.rid, r.status, r.priority, r.deadline_ms,
                r.submitted_step) for r in s._q)
    return (q, [(r.rid, r.status, r.priority) for r in s.rejected],
            s.depth_by_class(), s.priorities_queued(), len(s))


def _run(mod, script, cfg=None):
    """Replay ``script`` on one package's scheduler -> what each pop gave
    and the state after every step."""
    s = mod.Scheduler(mod.SchedulerConfig(**(cfg or {})))
    pops, last = [], None
    for op, kw in script:
        if op == "submit":
            r = s.submit({"tokens": np.zeros((kw.pop("P", 4),), np.int32)},
                         **kw)
            r.submit_time = T0
        elif op == "pop":
            kw = dict(kw)
            if kw.get("est_admit_ms") == "per_token":
                kw["est_admit_ms"] = lambda req: 3.0 * req.prompt_len
            got = last = s.pop(**kw)
            pops.append(None if got is None else
                        (got.rid, got.status, got.priority, got.deadline_ms))
        elif op == "requeue":            # the request popped last
            s.requeue(last)
        pops.append(_state(s))
    return pops


def _scripts():
    """(name, script, SchedulerConfig kwargs): ordering, aging, the
    infeasible deadline both ways, a callable admit estimate, requeue."""
    sub = lambda **kw: ("submit", kw)          # noqa: E731
    pop = lambda **kw: ("pop", kw)             # noqa: E731
    order = [sub(priority=1, deadline_ms=5e3), sub(priority=1),
             sub(priority=1, deadline_ms=1e3), sub(priority=0),
             sub(priority=3), sub(priority=1, deadline_ms=1e3)] + \
        [pop(now=T0)] * 7
    aging = [sub(priority=3, submitted_step=0)]
    for step in range(0, 40, 2):
        aging += [sub(priority=0, submitted_step=step),
                  pop(now_step=step, now=T0)]
    infeasible = [sub(priority=0, deadline_ms=10.0, max_new_tokens=100),
                  sub(priority=1),
                  sub(priority=0, deadline_ms=500.0, max_new_tokens=4),
                  pop(now=T0, est_step_ms=5.0, est_admit_ms=5.0),
                  pop(now=T0 + 0.49, est_step_ms=5.0, est_admit_ms=5.0),
                  pop(now=T0, est_step_ms=5.0, est_admit_ms=5.0),
                  pop(now=T0)]
    per_token = [sub(priority=0, deadline_ms=30.0, max_new_tokens=2, P=4),
                 sub(priority=0, deadline_ms=30.0, max_new_tokens=2, P=12),
                 pop(now=T0, est_step_ms=1.0, est_admit_ms="per_token"),
                 pop(now=T0, est_step_ms=1.0, est_admit_ms="per_token")]
    requeue = [sub(priority=2, submitted_step=0),
               sub(priority=2, submitted_step=5),
               sub(priority=1, submitted_step=9),
               pop(now_step=10, now=T0), ("requeue", {}),
               pop(now_step=12, now=T0), ("requeue", {}),
               sub(priority=1, submitted_step=13),
               pop(now_step=20, now=T0), pop(now_step=20, now=T0),
               pop(now_step=20, now=T0), pop(now_step=20, now=T0)]
    return [("order", order, {}), ("aging", aging, {"aging_steps": 8}),
            ("reject", infeasible, {}),
            ("degrade", infeasible, {"on_infeasible": "degrade"}),
            ("per_token", per_token, {}),
            ("requeue", requeue, {"aging_steps": 4})]


@pytest.mark.parametrize("name,script,cfg", _scripts(),
                         ids=[s[0] for s in _scripts()])
def test_scheduler_matches_reference(name, script, cfg):
    got = _run(sched, [(op, dict(kw)) for op, kw in script], cfg)
    want = _run(jsched, [(op, dict(kw)) for op, kw in script], cfg)
    assert got == want
    pops = [p for p in got if p is None or len(p) == 4]
    assert any(p is not None for p in pops), name


def test_scheduler_orders_edf_within_class_and_rejects():
    """The rules themselves, in the port: EDF within the most urgent
    class, deadline-less after deadlined, FIFO by rid; an infeasible
    deadline rejected, never popped."""
    s = sched.Scheduler()
    z = {"tokens": np.zeros((4,), np.int32)}
    loose = s.submit(z, priority=1, deadline_ms=5e3)
    none = s.submit(z, priority=1)
    tight = s.submit(z, priority=1, deadline_ms=1e3)
    urgent = s.submit(z, priority=0)
    assert [s.pop(now=T0).rid for _ in range(4)] == [
        urgent.rid, tight.rid, loose.rid, none.rid]
    doomed = s.submit(z, priority=0, deadline_ms=10.0, max_new_tokens=100)
    ok = s.submit(z, priority=1)
    assert s.pop(now=doomed.submit_time, est_step_ms=5.0,
                  est_admit_ms=5.0).rid == ok.rid
    assert doomed.status == "rejected" and s.rejected == [doomed]
    assert s.pop() is None


@pytest.mark.parametrize("kw", [dict(aging_steps=0), dict(aging_steps=-3),
                                dict(on_infeasible="drop"),
                                dict(on_infeasible="REJECT")])
def test_scheduler_config_validation(kw):
    for mod in PKGS.values():
        with pytest.raises(ValueError):
            mod.SchedulerConfig(**kw)
    assert dataclasses.asdict(sched.SchedulerConfig()) == \
        dataclasses.asdict(jsched.SchedulerConfig())


def _classes(mod):
    return [mod.TrafficClass(priority=0, rate=0.15, prompt_lens=(16, 32),
                             new_tokens=(8,), deadline_ms=60_000.0),
            mod.TrafficClass(priority=2, rate=0.1, prompt_lens=(48, 96),
                             new_tokens=(8,), burst_every=8, burst_size=2),
            mod.TrafficClass(priority=1, rate=0.7, prompt_lens=(3, 5, 7),
                             new_tokens=(1, 2, 3))]


@pytest.mark.parametrize("steps,seed", [(24, 11), (20, 11), (50, 0)])
def test_poisson_trace_and_prompts_match_reference(steps, seed):
    got = traffic.poisson_trace(_classes(traffic), steps, seed=seed)
    want = jtraffic.poisson_trace(_classes(jtraffic), steps, seed=seed)
    assert [dataclasses.astuple(a) for a in got] == \
        [dataclasses.astuple(a) for a in want]
    assert len(got) > 0 and [a.step for a in got] == sorted(
        a.step for a in got)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for a in got[:8]:
        pa = traffic.make_prompt(ra, a.prompt_len, 49152)
        pb = jtraffic.make_prompt(rb, a.prompt_len, 49152)
        assert pa.dtype == pb.dtype == np.int32
        assert np.array_equal(pa, pb)


def _finished(cls, seed):
    """Finished requests of three classes: done within and past their
    deadlines, rejected, unfinished, and one without an admission."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(40):
        r = cls(rid=rid, inputs={"tokens": np.zeros((4,), np.int32)},
                priority=int(rng.integers(0, 3)),
                deadline_ms=(None if rid % 3 == 0 else
                             float(rng.choice([50.0, 400.0]))))
        r.submit_time = T0 + 0.01 * rid
        r.submitted_step = rid // 2
        kind = rid % 5
        if kind in (0, 1, 2):
            r.status = "done"
            r.admitted_step = r.submitted_step + int(rng.integers(0, 6))
            r.finish_time = r.submit_time + float(rng.uniform(0.01, 0.6))
        elif kind == 3:
            r.status = "rejected"
        else:
            r.status = "active"
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_class_report_matches_reference(seed):
    got = traffic.class_report(_finished(Request, seed))
    want = jtraffic.class_report(_finished(JRequest, seed))
    assert got == want
    assert set(got) == {"0", "1", "2"}
    assert sum(c["submitted"] for c in got.values()) == 40
