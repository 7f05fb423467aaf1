"""``ServeEngine.decode``'s invalid rows against the reference's
``jnp.where(valid, new, old)``, on the reduced configs of gemma3-4b (ring
caches of 8 slots on its local layers), mamba2-370m (SSD state rows) and
recurrentgemma-2b (RG-LRU state rows and 8-slot rings).

The step writes every row; the engine saves what it writes in the rows
whose ``valid`` is False and puts it back after: a sequence leaf (``k``,
``v``, ``pos``) at slot ``index % L`` with L **that leaf's** length, a
state leaf (``ssm``, ``conv``, ``h``) as its whole row. Restoring at
``index % total_len`` indexed a ring of 8 slots with 12 (``IndexError``;
on the card a device-side assert), restored slot 2 where the step wrote
slot 6 of a ring when ``total_len`` is 20 and the index 22, and indexed a
state leaf's head or width axis with a position.

Each case: caches drawn from a seed (every leaf, positions included),
rung 2, ``valid = [True, False]``:

  * row 1 of every leaf is bit-identical to the caches before the step;
  * row 0 of every leaf is bitwise what the same step with both rows
    valid writes (the restore touches no valid row), and within 5e-2 of
    each leaf's largest magnitude of the reference engine's decode on the
    same caches (its K/V and state rows carry the step's bf16
    projections, which torch and XLA round after sums in other orders;
    positions exactly);
  * the same bit-identity when the step fails part way, an injected error
    after the first layer has written (the OOM step-down's promise).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as jregistry  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402

TOL = 5e-2
#: (arch, total_len, the invalid row's index): 12 past an 8-slot ring;
#: 22 with total_len 20, whose slot 22 % 20 = 2 lies inside the ring but
#: is not the slot the step writes (22 % 8 = 6)
CASES = [("gemma3-4b", 32, 12), ("gemma3-4b", 20, 22),
         ("mamba2-370m", 32, 12), ("recurrentgemma-2b", 32, 12)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The reference's reduced params of each arch (one init each)."""
    out = {}
    for arch in sorted({c[0] for c in CASES}):
        task = JLMTask(jregistry.get_model_config(arch, reduced=True))
        out[arch] = jax.device_get(split_params(
            task.init(jax.random.PRNGKey(0))[0])[0])
    return out


def _engines(arch, params, total):
    kw = dict(total_len=total, prompt_len=8, rungs=(2,), tiers=(1,))
    jeng = jengine.ServeEngine(
        JLMTask(jregistry.get_model_config(arch, reduced=True)), params,
        **kw)
    eng = engine.ServeEngine(registry.get_task(arch, reduced=True,
                                               device="cpu"),
                             bridge.lm_params(params), device="cpu", **kw)
    return jeng, eng


def _drawn(eng, seed):
    """The engine's rung-2 caches with every leaf drawn: floating leaves
    normal in their dtype, positions in [-1, 40)."""
    rng = np.random.default_rng(seed)

    def fill(name, c):
        if name == "pos":
            c.copy_(torch.from_numpy(rng.integers(-1, 40, c.shape)))
        else:
            c.copy_(torch.from_numpy(
                rng.standard_normal(c.shape).astype(np.float32)))
        return c
    return engine._map_named(fill, eng.init_caches(2))


def _to_jax(caches):
    def one(x):
        a = bridge.to_numpy(x)
        return jnp.asarray(a.view(ml_dtypes.bfloat16)
                           if x.dtype == torch.bfloat16 else a)
    return tu.tree_map(one, caches)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _clone(caches):
    return tu.tree_map(lambda c: c.clone(), caches)


@pytest.mark.parametrize("arch,total,index", CASES)
def test_invalid_row_stays_bit_identical(models, arch, total, index):
    jeng, eng = _engines(arch, models[arch], total)
    before = _drawn(eng, 3)
    token = np.array([7, 9], np.int32)
    idx = np.array([5, index], np.int32)
    valid = np.array([True, False])

    caches = _clone(before)
    out, caches = eng.decode(2, 1, caches, token, idx, valid)
    both = _clone(before)
    out_all, both = eng.decode(2, 1, both, token, idx)
    assert int(out[0]) == int(out_all[0])
    _, jnew = jeng.decode(2, 1, _to_jax(before), token, idx, valid)
    names = [n for n, _ in engine._named_leaves(caches)]
    assert {"ssm", "conv", "h", "k"} & set(names)
    for name, g, b, a, w in zip(names, tu.leaves(caches), tu.leaves(before),
                                tu.leaves(both), jax.tree.leaves(jnew)):
        assert torch.equal(g[:, 1], b[:, 1]), (arch, name, "row 1 moved")
        assert torch.equal(g[:, 0], a[:, 0]), (arch, name, "row 0")
        got, want = _np(g[:, 0]), _np(w)[:, 0]
        if name == "pos":
            np.testing.assert_array_equal(got, want)
        else:
            gap = float(np.abs(got - want).max())
            assert gap <= TOL * float(np.abs(want).max()), (arch, name, gap)
        if name in engine.SEQUENCE_LEAVES:        # one slot written a row
            L = g.shape[2]
            moved = (a[:, 0] != b[:, 0]).reshape(a.shape[0], L, -1).any(-1)
            assert set(torch.nonzero(moved)[:, 1].tolist()) <= {5 % L}
        else:
            assert not torch.equal(a[:, 0], b[:, 0]), (arch, name)


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_invalid_row_restored_when_the_step_fails(models, arch, monkeypatch):
    """An error raised after the first layer wrote its rows: the invalid
    row is restored in every leaf all the same (the engine's ``finally``)."""
    from repro_torch.nn import blocks
    _, eng = _engines(arch, models[arch], 32)
    before = _drawn(eng, 4)
    caches = _clone(before)
    real, calls = blocks._block_fwd, []

    def failing(*a, **kw):
        if calls:
            raise torch.OutOfMemoryError("injected after the first block")
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(blocks, "_block_fwd", failing)
    with pytest.raises(torch.OutOfMemoryError):
        eng.decode(2, 1, caches, np.array([1, 2], np.int32),
                   np.array([5, 12], np.int32), np.array([True, False]))
    wrote = False
    for g, b in zip(tu.leaves(caches), tu.leaves(before)):
        assert torch.equal(g[:, 1], b[:, 1])
        wrote |= not torch.equal(g[:, 0], b[:, 0])
    assert wrote                     # the first layer did write row 0
