"""Port parity: the Tri-Accel control math (``core.controller``,
``core.precision``, ``train.schedules``) and the memory-elastic batch
controller (``core.batch_scaler``) against the reference package.

Tolerances: ``update_control``, ``lr_scales`` and ``codes_from_stats`` are
bitwise over random per-layer moments on both ladders (every field of the
control state, the gpu ladder's loss-scale halve/double/cap law included).
``warmup_cosine`` is bitwise over the warmup; on the cosine leg the two
take ``cos`` from different libraries (XLA's and torch's), which differ by
up to one f32 ulp of the cosine, so there the learning rate is held within
base_lr * (1 - final_frac) / 2 * 2^-23 plus one ulp of its own rounding.
``BatchScaler``
makes the same decisions, and its memory model the same predictions
(plain Python floats in both, so exactly equal), when both are fed the same
measured-bytes sequence.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import batch_scaler as jbs  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.train.schedules import warmup_cosine as jwarmup  # noqa: E402
from repro_torch.core import batch_scaler as tbs  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.train.schedules import warmup_cosine  # noqa: E402

L = 11


def _cfg_kw(ladder, curvature=True, precision=True):
    return dict(ladder=ladder, t_ctrl=3, t_curv=4, tau_low=3e-9,
                tau_high=1e-5, alpha=0.05, tau_curv=50.0,
                enable_curvature=curvature, enable_precision=precision)


def _assert_state_equal(ts, js, msg=""):
    for name in tctl.ControlState._fields:
        a = getattr(ts, name).numpy()
        b = np.asarray(getattr(js, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {msg}")


def _moments(rng, counts):
    """Per-layer (sum, sum_sq) whose variances span both thresholds."""
    var = 10.0 ** rng.uniform(-11, -3, L)
    mean = rng.standard_normal(L) * np.sqrt(var) * 0.3
    s = (mean * counts).astype(np.float32)
    ss = ((var + mean ** 2) * counts).astype(np.float32)
    return s, ss


@pytest.mark.parametrize("curvature", [True, False])
@pytest.mark.parametrize("ladder", ["gpu", "tpu"])
def test_update_control_and_lr_scales_bitwise(ladder, curvature):
    kw = _cfg_kw(ladder, curvature)
    jcfg, tcfg = jprec.TriAccelConfig(**kw), tprec.TriAccelConfig(**kw)
    rng = np.random.default_rng(0)
    counts = rng.integers(10, 600_000, L).astype(np.float32)
    js = jctl.init_control(L, jcfg)
    ts = tctl.init_control(L, tcfg)
    _assert_state_equal(ts, js, "init")
    # 998 clean steps already: the loss scale doubles at the 2nd step
    js = js._replace(good_steps=jnp.asarray(998, jnp.int32))
    ts = ts._replace(good_steps=torch.tensor(998, dtype=torch.int32))
    for step in range(9):
        if step == 4:           # the t_curv refresh
            lam = (10.0 ** rng.uniform(-1, 3, L)).astype(np.float32)
            js = jctl.with_curvature(js, jnp.asarray(lam))
            ts = tctl.with_curvature(ts, torch.from_numpy(lam))
        s, ss = _moments(rng, counts)
        finite = step not in (5, 6)          # two overflow steps
        js = jctl.update_control(js, tuple(map(jnp.asarray, (s, ss, counts))),
                                 jcfg, jnp.asarray(finite))
        ts = tctl.update_control(
            ts, tuple(map(torch.from_numpy, (s, ss, counts))), tcfg,
            torch.tensor(finite))
        _assert_state_equal(ts, js, f"step {step}")
        np.testing.assert_array_equal(tctl.lr_scales(ts, tcfg).numpy(),
                                      np.asarray(jctl.lr_scales(js, jcfg)))
    if ladder == "gpu":
        # 2^15 -> doubled at the 1000th clean step -> halved twice
        assert float(ts.loss_scale) == 2.0 ** 14
    codes = ts.codes.numpy()
    assert set(codes.tolist()) - {0, 1, 2} == set()


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_codes_from_stats_bitwise(flags):
    curvature, precision = flags
    kw = _cfg_kw("gpu", curvature, precision)
    jcfg, tcfg = jprec.TriAccelConfig(**kw), tprec.TriAccelConfig(**kw)
    rng = np.random.default_rng(1)
    var = (10.0 ** rng.uniform(-11, -2, 64)).astype(np.float32)
    var[:3] = [3e-9, 1e-5, 0.0]                    # on the thresholds
    lam = (10.0 ** rng.uniform(0, 3, 64)).astype(np.float32)
    lam[3] = 50.0
    want = np.asarray(jprec.codes_from_stats(jnp.asarray(var),
                                             jnp.asarray(lam), jcfg))
    got = tprec.codes_from_stats(torch.from_numpy(var),
                                 torch.from_numpy(lam), tcfg).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert got.dtype == np.int32


def test_ladder_loss_scale_cap():
    """The gpu ladder's loss scale never passes 2^24."""
    kw = _cfg_kw("gpu")
    jcfg, tcfg = jprec.TriAccelConfig(**kw), tprec.TriAccelConfig(**kw)
    counts = np.full(L, 100.0, np.float32)
    s, ss = np.zeros(L, np.float32), np.ones(L, np.float32)
    js = jctl.init_control(L, jcfg)._replace(
        loss_scale=jnp.asarray(2.0 ** 24, jnp.float32),
        good_steps=jnp.asarray(999, jnp.int32))
    ts = tctl.init_control(L, tcfg)._replace(
        loss_scale=torch.tensor(2.0 ** 24),
        good_steps=torch.tensor(999, dtype=torch.int32))
    js = jctl.update_control(js, tuple(map(jnp.asarray, (s, ss, counts))),
                             jcfg, jnp.asarray(True))
    ts = tctl.update_control(ts, tuple(map(torch.from_numpy,
                                           (s, ss, counts))), tcfg,
                             torch.tensor(True))
    _assert_state_equal(ts, js)
    assert float(ts.loss_scale) == 2.0 ** 24 and int(ts.good_steps) == 0


@pytest.mark.parametrize("sched", [(0.05, 5, 50), (3e-3, 20, 200),
                                   (0.1, 0, 7)])
def test_warmup_cosine_bitwise(sched):
    jfn, tfn = jwarmup(*sched), warmup_cosine(*sched)
    steps = np.arange(0, sched[2] + 5, dtype=np.int32)
    want = np.asarray([np.asarray(jfn(jnp.asarray(s))) for s in steps])
    got = np.asarray([tfn(torch.tensor(int(s), dtype=torch.int32)).item()
                      for s in steps], np.float32)
    warm = steps < sched[1]
    np.testing.assert_array_equal(got[warm], want[warm])
    tol = sched[0] * (1 - 0.05) * 0.5 * 2.0 ** -23 + np.spacing(want)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want) / tol


def _vision_model(mod):
    mm = mod.MemoryModel(param_count=11_173_962, opt_slots=1,
                         act_bytes_per_token_layer=2 * 1.2e6, num_layers=1,
                         fixed_overhead=0.05e9)
    mm.calibrate(0.35e9, 96, codes=[2], ladder="gpu")
    return mm


@pytest.mark.parametrize("ladder", ["gpu", "tpu"])
def test_batch_scaler_same_decisions(ladder):
    kw = dict(_cfg_kw(ladder), mem_cap_bytes=0.4e9, rho_low=0.8,
              rho_high=0.92)
    jcfg, tcfg = jprec.TriAccelConfig(**kw), tprec.TriAccelConfig(**kw)
    rungs = (16, 32, 48, 64)
    jsc = jbs.BatchScaler(rungs, 1, _vision_model(jbs), jcfg, start_rung=32)
    tsc = tbs.BatchScaler(rungs, 1, _vision_model(tbs), tcfg, start_rung=32)
    assert tsc.microbatch == jsc.microbatch
    rng = np.random.default_rng(2)
    codes = [0, 1, 2] * 3 + [1, 1]
    for step in range(1, 40):
        if step == 17:              # an OOM on the live rung
            assert tsc.mark_oom() == jsc.mark_oom()
            continue
        measured = None if step % 5 == 0 else \
            float(rng.uniform(0.2, 0.45) * 1e9)
        codes = rng.integers(0, 3, L).tolist()
        a = jsc.observe(step * 10, codes=codes, measured_bytes=measured)
        b = tsc.observe(step * 10, codes=codes, measured_bytes=measured)
        assert a == b, step
    assert tsc.history == jsc.history
    assert tsc.model.measured == jsc.model.measured
    assert tsc.model.poisoned == jsc.model.poisoned
    assert tsc.model.calibration == jsc.model.calibration
    for r in rungs:
        assert tsc.model.predict(r, r, codes, ladder) == \
            jsc.model.predict(r, r, codes, ladder)
    assert tbs.TIER_BYTES == jbs.TIER_BYTES


@pytest.mark.parametrize("measured", [
    [5e-324, 1.0],
    [1e-310, 0.0, 2e10, 5e-324, 3e8],
    [0.0, 5e-324, 5e-324, 1e9],
])
def test_batch_scaler_subnormal_measurement_keeps_calibration(measured):
    """A subnormal measured footprint carries no scale information: the
    port keeps its calibration positive and every later re-fit finite."""
    tcfg = tprec.TriAccelConfig(**dict(_cfg_kw("gpu"), mem_cap_bytes=0.4e9))
    rungs = (16, 32, 48, 64)
    tsc = tbs.BatchScaler(rungs, 1, _vision_model(tbs), tcfg, start_rung=32)
    for i, m in enumerate(measured):
        assert tsc.observe(i, measured_bytes=m) in rungs
        assert tsc.model.calibration > 0
        assert np.isfinite(tsc.model.total(tsc.microbatch))


def test_measured_peak_bytes_is_none_on_the_cpu():
    out, peak = tbs.measured_peak_bytes(lambda: 7, "cpu")
    assert (out, peak) == (7, None)
