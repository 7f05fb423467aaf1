"""Port parity for serving the recurrent architectures (the reduced
mamba2-370m and recurrentgemma-2b) against ``repro.serve`` with the
reference's weights (``bridge.lm_params``), on the CPU with one torch
thread. Their decode caches hold state rows (SSD's ``ssm`` and ``conv``,
RG-LRU's ``h`` and ``conv``; f32), which a decode step advances and
which are not idempotent, beside recurrentgemma's 8-slot rings.

  * A whole-prompt session and a chunked one (chunk 3: ragged on 8-token
    prompts) of each package, two requests, the second after two steps
    (rungs 1 -> 2, so the state rows cross a repack, and a row prefills
    chunk by chunk while the other decodes), caches of 32 positions (the
    ring wraps): the port's greedy tokens equal the reference's session's
    of the same mode; where a token differs, the reference's top-2 logit
    margin there (its decode hook, teacher-forced) lies within LOGIT_TOL
    = 0.02, the bound of ``tests/test_torch_lm_serve.py`` (bf16 rounded
    in another order flips near-ties). No path runs after ``warm()``.
  * ``chunk_admit``: chunks of 3 of an 8-token prompt into slot 1 of a
    rung-2 cache whose slot 0 holds another request leave the cache
    tensors the same objects (the decode wrote the state rows in place
    through views of slot 1), slot 0 bit-identical, and slot 1's rows
    equal to the reference's chunk executable's: positions exactly, every
    other leaf within CACHE_TOL = 5e-2 of its largest magnitude (the
    bound of ``test_torch_dense_archs.py``); a fresh first chunk clears
    the state rows first.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_dense_archs import (  # noqa: E402, F401 (a fixture)
    CACHE_TOL, LOGIT_TOL, _np, _one_intra_op_thread)

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
VOCAB, PROMPT, TOTAL = 512, 8, 32


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j = jregistry.get_model_config(arch, reduced=True)
    pj = jax.device_get(split_params(JLMTask(cfg_j).init(
        jax.random.PRNGKey(0))[0])[0])
    return dict(arch=arch, cfg_j=cfg_j, pj=pj, pt=bridge.lm_params(pj))


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (PROMPT,)).astype(np.int32)
            for _ in range(n)]


def _serve(sess, prompts):
    n = sess.warm()
    sess.submit({"tokens": prompts[0]})
    sess.step()
    sess.step()
    sess.submit({"tokens": prompts[1]})
    sess.run(max_steps=200)
    assert sess.compile_count == n                 # no path after warm()
    return {rid: list(r.tokens) for rid, r in sess.results().items()}


def _ref_margins(model, prompt, tokens):
    """The reference's top-2 logit margin at each generated position: its
    decode hook at tier 1, teacher-forced over the prompt and tokens."""
    cfg = model["cfg_j"]
    params = jengine.tier_params(model["pj"], 1, "tpu")
    dec = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i, cfg))
    caches = jlm.lm_init_cache(cfg, 1, TOTAL)
    seq = list(prompt) + list(tokens)
    margins = []
    for i, t in enumerate(seq[:-1]):
        logits, caches = dec(params, jnp.asarray([t], jnp.int32), caches,
                             jnp.asarray([i], jnp.int32))
        if i >= len(prompt) - 1:
            top = np.sort(_np(logits)[0])[-2:]
            margins.append(float(top[1] - top[0]))
    return margins


@pytest.mark.parametrize("chunk", [None, 3])
def test_session_tokens_match_reference(model, chunk):
    kw = dict(prompt_len=PROMPT, total_len=TOTAL, rungs=(1, 2), tiers=(1,),
              ladder="tpu", max_new_tokens=10, t_ctrl=4,
              prefill_chunk=chunk)
    prompts = _prompts(2, 2)
    sj = jsession.ServeSession(JLMTask(model["cfg_j"]),
                               jsession.ServeConfig(**kw),
                               params=model["pj"])
    st = ServeSession(registry.get_task(model["arch"], reduced=True,
                                        device="cpu"),
                      ServeConfig(**kw), params=model["pt"], device="cpu")
    assert st.chunked == sj.chunked == (chunk is not None)
    want, got = _serve(sj, prompts), _serve(st, prompts)
    assert st.engine.runs["repack"] >= 1
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == kw["max_new_tokens"]
        if got[rid] != toks:
            pos = next(i for i, (a, b) in enumerate(zip(got[rid], toks))
                       if a != b)
            m = _ref_margins(model, prompts[rid], toks)
            assert m[pos] <= LOGIT_TOL, (rid, pos, m[pos])


def test_chunk_admit_state_rows_match_reference(model):
    kw = dict(total_len=TOTAL, prompt_len=PROMPT, rungs=(2,), tiers=(1,),
              prefill_chunk=3)
    eng = engine.ServeEngine(registry.get_task(model["arch"], reduced=True,
                                               device="cpu"), model["pt"],
                             device="cpu", **kw)
    jeng = jengine.ServeEngine(JLMTask(model["cfg_j"]), model["pj"], **kw)
    a, b = _prompts(2, 5)
    caches, jc = eng.init_caches(2), jeng.init_caches(2)
    leaves = tu.leaves(caches)
    for f in range(0, PROMPT, 3):                  # slot 0: a whole prompt
        n = min(3, PROMPT - f)
        _, caches = eng.chunk_admit(2, 1, caches, 0, a[f:f + 3], f, n,
                                    f == 0)
        _, jc = jeng.chunk_admit(2, 1, jc, 0, np.pad(a[f:f + 3], (
            0, 3 - len(a[f:f + 3]))), f, n, f == 0)
    row0 = [c[:, 0].clone() for c in leaves]
    # slot 1 held a stale occupant: the fresh first chunk clears it
    for c in leaves:
        c[:, 1] = 7
    for f in (0, 3):
        _, out = eng.chunk_admit(2, 1, caches, 1, b[f:f + 3], f, 3, f == 0)
        assert out is caches
        _, jc = jeng.chunk_admit(2, 1, jc, 1, b[f:f + 3], f, 3, f == 0)
    assert all(x is y for x, y in zip(tu.leaves(caches), leaves))
    for c, r in zip(leaves, row0):
        assert torch.equal(c[:, 0], r)
    names = [n for n, _ in engine._named_leaves(caches)]
    assert {"conv"} < set(names)
    for name, g, w in zip(names, leaves, jax.tree.leaves(
            jax.device_get(jc))):
        g, w = _np(g), _np(w)
        if name == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            gap = float(np.abs(g - w).max())
            assert gap <= CACHE_TOL * float(np.abs(w).max()), (name, gap)
