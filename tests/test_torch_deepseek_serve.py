"""Port parity for serving an MLA/MoE model: deepseek-v2-lite-16b's reduced
config in a ``ServeSession`` of each package, the reference's weights, the
same prompts submitted at the same steps (one up front, two more after two
steps), so the batch composition of every step is the same on both sides.
That matters for this architecture: the MoE capacity is shared by the rows
of a decode batch (C = 1 at rung 2), so a request's tokens depend on its
batch-mates, and a check may only compare the two packages at one
composition.

  * f32 (``compute_dtype``, tier 2 weights and an f32 cache on both
    sides): the rung and tier histories equal, every request's tokens
    equal and its first-token step equal; the rung moves 1 -> 2 -> 1, so
    the MLA caches (``ckv``, ``kr``, ``pos``) go through the prefill
    scatter and both repacks;
  * bf16 as served (tier 1, then the fp8 tier 0 pinned after four
    steps): the same (every token equal as measured; a routing or argmax
    near-tie that a bf16 ulp flips, as ``test_torch_deepseek`` finds for
    the router, would show here first).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSession as JServeSession  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
P, TOTAL, NEW = 12, 24, 6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _sessions(f32: bool):
    cfg_j = jregistry.get_model_config(ARCH, reduced=True)
    cfg_t = registry.get_model_config(ARCH, reduced=True)
    if f32:
        cfg_j = dataclasses.replace(cfg_j, compute_dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, compute_dtype=torch.float32)
    pj = jax.device_get(split_params(
        jlm.lm_init(jax.random.PRNGKey(0), cfg_j))[0])
    kw = dict(prompt_len=P, total_len=TOTAL, rungs=(1, 2),
              tiers=(2,) if f32 else (0, 1), ladder="tpu",
              max_new_tokens=NEW, t_ctrl=4)
    sj = JServeSession(JLMTask(cfg_j), JServeConfig(
        **kw, cache_dtype=jnp.float32 if f32 else jnp.bfloat16), params=pj)
    st = ServeSession(LMTask(cfg_t, device="cpu"), ServeConfig(
        **kw, cache_dtype=torch.float32 if f32 else torch.bfloat16),
        params=bridge.lm_params(pj), device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (3, P)).astype(np.int32)
    for sess in (sj, st):
        sess.submit({"tokens": prompts[0]})
        for _ in range(2):
            sess.step()
        for p in prompts[1:]:
            sess.submit({"tokens": p})
        if not f32:
            for _ in range(2):
                sess.step()
            sess.set_tier(0)
    return sj, st, sj.run(), st.run()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_deepseek_session_matches_reference(dtype):
    sj, st, rj, rt = _sessions(dtype == "f32")
    assert rt["rung_history"] == rj["rung_history"]
    assert rt["tier_history"] == rj["tier_history"]
    assert [r for _, r in rt["rung_history"]][:3] == [1, 2, 1]
    assert st.engine.runs["repack"] >= 2
    for rid, req_j in sj.results().items():
        req_t = st.results()[rid]
        assert req_t.status == req_j.status == "done"
        assert len(req_t.tokens) == len(req_j.tokens) == NEW
        assert req_t.tokens == req_j.tokens, rid
        assert req_t.first_token_step == req_j.first_token_step
