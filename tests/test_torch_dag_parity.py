"""The port's compiled DAGs against the JAX package on the same inputs: a
two-stage compiled pipeline of GPT nano (stage A the forward with the
weights ``models/convert.py`` carries, stage B the next tokens from the
last position's f32 log-softmax) against the reference's ``gpt.apply``
at tests/test_torch_gpt.py's atol 1e-4, and the port's ``REDUCERS``
against ``ray_tpu.dag.collective.REDUCERS``, bitwise, on numpy inputs
and on tensors of the same values.  The edge between the stages takes
the raw tensor path, as CUDA tensors do on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.dag.collective import REDUCERS as REF_REDUCERS
from ray_tpu.models import gpt as jgpt
from test_torch_collective import _fresh_device_ledger  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag.channel import DEVICE_CHANNEL_ENV
from ray_tpu_torch.dag.collective import REDUCERS

torch.set_num_threads(1)

RAW = {"env_vars": {DEVICE_CHANNEL_ENV: "1"}}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


@rt.remote
class ForwardStage:
    def __init__(self, np_params):
        torch.set_num_threads(1)
        from ray_tpu_torch.models import convert, gpt

        self.cfg = gpt.GPTConfig.nano(dtype=torch.float32)
        self.params = convert.from_jax_params(np_params, self.cfg,
                                              device="cpu")

    def last_logits(self, tokens):
        from ray_tpu_torch.models import gpt

        with torch.no_grad():
            logits = gpt.apply(self.params, tokens, self.cfg, device="cpu")
        return logits[:, -1].contiguous()


@rt.remote
class SampleStage:
    def __init__(self):
        self.seen = []

    def next_tokens(self, logits):
        self.seen.append(logits)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return torch.argmax(logp, dim=-1)

    def last_seen(self):
        return self.seen[-1]


def test_compiled_gpt_pipeline_matches_jax(cluster, monkeypatch):
    monkeypatch.setenv(DEVICE_CHANNEL_ENV, "1")
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    a = ForwardStage.options(runtime_env=RAW).remote(np_params)
    b = SampleStage.options(runtime_env=RAW).remote()
    with InputNode() as inp:
        dag = b.next_tokens.bind(a.last_logits.bind(inp))
    cd = dag.experimental_compile()
    try:
        for seed in (0, 1, 2):
            tokens = np.random.RandomState(seed).randint(0, 256, (2, 48))
            want = np.asarray(jgpt.apply(jparams, jnp.asarray(tokens),
                                         jcfg))[:, -1]
            nxt = cd.execute(torch.from_numpy(tokens)).get(timeout=120)
            assert nxt.dtype == torch.int64 and tuple(nxt.shape) == (2,)
            assert np.array_equal(nxt.numpy(), want.argmax(-1))
    finally:
        cd.teardown()
    seen = rt.get(b.last_seen.remote(), timeout=60)
    assert seen.dtype == torch.float32 and tuple(seen.shape) == (2, 256)
    np.testing.assert_allclose(seen.numpy(), want, atol=1e-4, rtol=0)


def _inputs(kind):
    rng = np.random.RandomState(7)
    if kind == "f32":
        return [rng.standard_normal(1000).astype(np.float32)
                for _ in range(3)]
    if kind == "f32-nan-inf":
        xs = [rng.standard_normal(64).astype(np.float32) for _ in range(2)]
        xs[0][[1, 5]] = [np.nan, np.inf]
        xs[1][[2, 5]] = [-np.inf, np.nan]
        return xs
    if kind == "i64":
        return [rng.randint(-50, 50, (4, 8)).astype(np.int64)
                for _ in range(4)]
    return [np.float64(1.5), np.float64(-2.25)]


@pytest.mark.parametrize("op", sorted(REF_REDUCERS))
@pytest.mark.parametrize("kind", ["f32", "f32-nan-inf", "i64", "scalar"])
def test_reducers_match_the_reference_bitwise(op, kind):
    xs = _inputs(kind)
    want = np.asarray(REF_REDUCERS[op]([x.copy() for x in xs]))
    got = np.asarray(REDUCERS[op]([x.copy() for x in xs]))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if kind == "scalar":
        return
    # the same values as tensors fold in the same order: the same bits
    # (NaN payloads aside, which numpy and torch may set differently)
    t = REDUCERS[op]([torch.from_numpy(x.copy()) for x in xs])
    assert isinstance(t, torch.Tensor)
    assert np.array_equal(t.numpy(), want, equal_nan=True)
    finite = np.isfinite(want) if want.dtype.kind == "f" else ...
    assert t.numpy()[finite].tobytes() == want[finite].tobytes()
