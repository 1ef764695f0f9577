"""The port's ring and Ulysses attention against the JAX package, on gloo
ranks.

The cases of tests/test_ops.py:191-249 (ring attention over sp = 8 and
sp = 4, its kernel body over the kernels' plain versions, its gradients,
Ulysses) and tests/test_collective_compression.py:383 (Ulysses' head
check) run on a module-scoped pool of eight spawned gloo ranks
(tests/_gloo_pool.py; the ranks import no JAX).  The reference's sp = 4
cases take four of its eight devices; here the eight ranks form a
(dp = 2, sp = 4) mesh, both dp lines computing the same ring, and the
test reads dp line 0.  Each rank passes its own sequence chunk and
returns its rows, and the test joins them.  Tolerances are the
reference's (2e-4 values, 5e-4 grads of the kernel body, 2e-4 grads of
the default body) against the port's O(S^2) ``mha_reference``.

Parity: the same q, k, v and output cotangent (numpy, seed 0) go
through the JAX package's ``ring_attention`` on a four-device CPU mesh
(``impl="xla"``, and ``"pallas_interpret"`` as its tests run it) and the
port's on four ranks with the same ``impl``: forward within 2e-5,
gradients within 5e-5.

The ring's kernel body on the card against its scan body is in
tests/test_torch_kernels.py (a file that imports no JAX).
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool
from ray_tpu_torch.ops.attention import mha_reference

WORLD = 8


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def _qkv(b, h, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


# -- rank-side bodies (module level: the ranks import them by name) ------


def _ring(q, k, v, sp, causal, impl="auto", cot=None, dtensor=False):
    """This rank's (sp index, dp index, output rows, grads of
    sum(out * cot) or None)."""
    from ray_tpu_torch.ops import ring_attention
    from ray_tpu_torch.parallel import (NamedSharding, PartitionSpec as P,
                                        axis_index, distribute, make_mesh)

    torch.manual_seed(0)
    mesh = make_mesh(dp=WORLD // sp, sp=sp, device_type="cpu")
    r, d = axis_index(mesh, "sp"), axis_index(mesh, "dp")
    if dtensor:
        sh = NamedSharding(mesh, P(None, None, "sp", None))
        out = ring_attention(*(distribute(torch.from_numpy(x), sh)
                               for x in (q, k, v)), mesh, "sp",
                             causal=causal, impl=impl)
        return r, d, out.to_local().numpy(), None
    blk = q.shape[2] // sp
    loc = [torch.from_numpy(x[:, :, r * blk:(r + 1) * blk].copy())
           .requires_grad_() for x in (q, k, v)]
    out = ring_attention(*loc, mesh, "sp", causal=causal, impl=impl)
    grads = None
    if cot is not None:
        (out * torch.from_numpy(cot[:, :, r * blk:(r + 1) * blk])).sum() \
            .backward()
        grads = [t.grad.numpy() for t in loc]
    return r, d, out.detach().numpy(), grads


def _ulysses(q, k, v, causal):
    from ray_tpu_torch.ops import ulysses_attention
    from ray_tpu_torch.parallel import axis_index, make_mesh

    mesh = make_mesh(dp=2, sp=4, device_type="cpu")
    r, d = axis_index(mesh, "sp"), axis_index(mesh, "dp")
    blk = q.shape[2] // 4
    loc = [torch.from_numpy(x[:, :, r * blk:(r + 1) * blk].copy())
           for x in (q, k, v)]
    return r, d, ulysses_attention(*loc, mesh, "sp", causal=causal).numpy(), \
        None


def _ulysses_validates():
    from ray_tpu_torch.ops import ulysses_attention
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(sp=WORLD, device_type="cpu")
    sp = WORLD
    heads = sp + 1
    q = torch.zeros((1, heads, 2, 8))
    with pytest.raises(ValueError, match=rf"heads \({heads}\).*\({sp}\)"):
        ulysses_attention(q, q, q, mesh, axis_name="sp")
    with pytest.raises(ValueError, match="not in"):
        ulysses_attention(q, q, q, mesh, axis_name="nope")
    return True


def _join(results):
    """dp line 0's rows in sp order, and its grads joined likewise."""
    line = sorted((r, out, g) for r, d, out, g in results if d == 0)
    out = np.concatenate([o for _, o, _ in line], axis=2)
    if line[0][2] is None:
        return out, None
    return out, [np.concatenate([g[i] for _, _, g in line], axis=2)
                 for i in range(3)]


def _ref(q, k, v, causal, cot=None):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = mha_reference(*ts, causal=causal)
    if cot is None:
        return out.detach().numpy(), None
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


# -- the reference's cases ------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(pool, causal):
    q, k, v = _qkv(b=1, h=2, s=256, d=16)
    out, _ = _join(pool.run(_ring, q, k, v, WORLD, causal, dtensor=True))
    ref, _ = _ref(q, k, v, causal)
    assert np.allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_pallas_kernels(pool, causal):
    """The kernel body (each chunk's (o, lse) merged in log space) over
    the kernels' plain versions matches dense attention, values and
    grads (of sum(out ** 2): cotangent 2·out)."""
    q, k, v = _qkv(b=1, h=2, s=256, d=16)
    ref, _ = _ref(q, k, v, causal)
    out, grads = _join(pool.run(_ring, q, k, v, 4, causal,
                                "pallas_interpret", 2 * ref))
    assert np.allclose(out, ref, atol=2e-4)
    _, g_ref = _ref(q, k, v, causal, 2 * ref)
    for a, b in zip(grads, g_ref):
        assert np.allclose(a, b, atol=5e-4)


def test_ring_attention_grads(pool):
    q, k, v = _qkv(b=1, h=2, s=64, d=16)
    ref, _ = _ref(q, k, v, True)
    _, grads = _join(pool.run(_ring, q, k, v, 4, True, "auto", 2 * ref))
    _, g_ref = _ref(q, k, v, True, 2 * ref)
    for a, b in zip(grads, g_ref):
        assert np.allclose(a, b, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_reference(pool, causal):
    q, k, v = _qkv(b=1, h=8, s=128, d=16)  # heads divisible by sp
    out, _ = _join(pool.run(_ulysses, q, k, v, causal))
    ref, _ = _ref(q, k, v, causal)
    assert np.allclose(out, ref, atol=2e-4)


def test_ulysses_validates_heads_divisible_by_sp(pool):
    assert all(pool.run(_ulysses_validates))


# -- parity with the JAX package --------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(pool, impl, causal):
    import jax

    from ray_tpu.ops.ring_attention import ring_attention as jring
    from ray_tpu.parallel import make_mesh as jmesh

    q, k, v = _qkv(b=1, h=2, s=256, d=16, seed=0)
    cot = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    mesh = jmesh(sp=4, devices=jax.devices()[:4])
    out_j, vjp = jax.vjp(lambda a, b, c: jring(a, b, c, mesh, "sp",
                                                causal=causal, impl=impl),
                         q, k, v)
    g_j = vjp(cot)
    out, grads = _join(pool.run(_ring, q, k, v, 4, causal, impl, cot))
    np.testing.assert_allclose(out, np.asarray(out_j), atol=2e-5, rtol=0)
    for a, b in zip(grads, g_j):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=0)
