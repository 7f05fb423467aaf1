"""Port parity for the chaos soak: ``repro_torch.resilience.soak`` against
``repro.resilience.soak``, on the CPU.

What must hold:
  * the train leg's report equals the reference's on every key both have
    (the OOM step-down, the rollback, the fault log, the restart's
    fall-back past the torn generation, the final step, ``lr_demote`` and
    the loss scale); the port's leg has no ``compiles_during_run`` (its
    eager ``Trainer`` compiles nothing), the only key it lacks;
  * the soak's module surface matches the reference's, and its tiny LM is
    the reference's config;
  * ``main`` on the CPU runs both legs, writes the report and returns 0,
    and leaves the SIGTERM / SIGINT handlers as it found them.
"""
import dataclasses
import inspect
import json
import signal

import pytest

torch = pytest.importorskip("torch")

from repro.resilience import soak as jsoak  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch.resilience import soak  # noqa: E402
from test_torch_serve_resilience import one_thread  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def train_legs():
    with one_thread():
        return jsoak.train_soak(), soak.train_soak(device="cpu")


def test_train_soak_report_matches_reference(train_legs):
    ref, port = train_legs
    assert set(ref) - set(port) == {"compiles_during_run"}
    assert set(port) <= set(ref)
    for key in port:
        assert port[key] == ref[key], key
    assert port["ok"] and port["preempted"] and port["restore_fell_back"]
    assert port["oom_events"] == [(3, 4)]
    assert port["rollback_events"] == [(11, 9)]
    assert (port["restored_step"], port["final_step"]) == (21, 24)
    assert (port["lr_demote"], port["loss_scale"]) == (0.5, 16384.0)
    assert port["fault_log"] == [
        ("train.step_oom", 3), ("train.nonfinite", 9),
        ("train.nonfinite", 10), ("train.nonfinite", 11),
        ("train.sigterm", 21), ("ckpt.corrupt", 21)]


def test_soak_surface_and_task_match_reference():
    for name in ("tiny_lm_task", "train_soak", "serve_soak", "main"):
        ref = list(inspect.signature(getattr(jsoak, name)).parameters)
        got = list(inspect.signature(getattr(soak, name)).parameters)
        assert got[:len(ref)] == ref, name
        assert got[len(ref):] == ([] if name == "main" else ["device"])
    assert "soak" not in res.__all__
    got, want = soak.tiny_lm_task(device="cpu").cfg, jsoak.tiny_lm_task().cfg
    for f in ("name", "family", "vocab_size", "tie_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("d_model", "d_ff", "act", "gated", "norm_eps", "remat"):
        assert getattr(got.stack, f) == getattr(want.stack, f), f
    assert got.stack.num_layers == want.stack.num_layers == 2
    ga, wa = got.stack.attn, want.stack.attn
    for f in (f.name for f in dataclasses.fields(ga)):
        assert getattr(ga, f) == getattr(wa, f), f


def test_main_on_the_cpu_writes_the_report(tmp_path, capsys):
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGINT)}
    out = tmp_path / "soak.json"
    assert soak.main(["--device", "cpu", "--out", str(out)]) == 0
    assert {s: signal.getsignal(s) for s in handlers} == handlers
    report = json.loads(out.read_text())
    assert report["ok"] and report["seed"] == 0
    assert [leg["leg"] for leg in report["legs"]] == ["train", "serve"]
    assert all(leg["ok"] for leg in report["legs"])
    assert json.loads(capsys.readouterr().out) == report
    serve = report["legs"][1]
    assert serve["compiles_during_run"] == 0 and serve["done"] == 6
    assert serve["oom_events"] == [[4, 2, 1, "decode"], [10, 1, 1, "admit"],
                                   [12, 2, 0, "admit"]]
