"""The port's runtime held against the JAX package on the CPU.

* One user script (tasks, an actor, put/get of a numpy array, ``wait``, a
  raised ``TaskError``) runs under ``ray_tpu`` and under
  ``ray_tpu_torch``, each in its own subprocess; their JSON outputs are
  equal.
* A CPU actor of the port's runtime takes GPT ``nano`` params made by
  ``ray_tpu.models.gpt.init`` (carried by ``models/convert.py``); its
  ``gpt.apply`` logits equal the JAX package's on the same tokens (f32,
  atol 1e-4, the tolerance of tests/test_torch_gpt.py).
* The two runtimes run on one host at once and neither attaches to the
  other's cluster, whichever address variable is set.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch as rt

REPO = Path(__file__).resolve().parent.parent
T = 60

_USER_SCRIPT = r"""
import importlib, json, sys
import numpy as np
rt = importlib.import_module(sys.argv[1])
rt.init(num_cpus=2)

@rt.remote
def square(x):
    return x * x

@rt.remote
def boom(tag):
    raise ValueError("boom-" + tag)

@rt.remote
class Acc:
    def __init__(self, start):
        self.total = start
    def add(self, v):
        self.total += v
        return self.total

out = {}
out["squares"] = rt.get([square.remote(i) for i in range(6)], timeout=60)
a = Acc.remote(10)
out["acc"] = rt.get([a.add.remote(i) for i in range(4)], timeout=60)
arr = np.arange(300_000, dtype=np.float32).reshape(600, 500)
ref = rt.put(arr)
back = rt.get(ref, timeout=60)
out["put_get"] = [list(back.shape), str(back.dtype), float(back.sum()),
                  bool(np.array_equal(back, arr))]
out["task_on_ref"] = rt.get(square.remote(ref), timeout=60)[599, 499].item()
ready, pending = rt.wait([square.remote(3), boom.remote("w")],
                         num_returns=2, timeout=60)
out["wait"] = [len(ready), len(pending)]
try:
    rt.get(boom.remote("x"), timeout=60)
    out["error"] = None
except rt.TaskError as e:
    out["error"] = [type(e).__name__, "boom-x" in str(e)]
rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
"""


def _run_user_script(package: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("RAY_TPU_ADDRESS", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    out = subprocess.run([sys.executable, "-c", _USER_SCRIPT, package],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_user_script_same_under_both_runtimes():
    ref = _run_user_script("ray_tpu")
    port = _run_user_script("ray_tpu_torch")
    assert port == ref
    assert ref["error"] == ["TaskError", True]
    assert ref["squares"] == [0, 1, 4, 9, 16, 25]


_TWO_RUNTIMES = r"""
import json, os, sys
import ray_tpu, ray_tpu_torch

ref_info = ray_tpu.init(num_cpus=1)
# the reference's address variable names its cluster: the port must not
# attach to it
os.environ["RAY_TPU_ADDRESS"] = ref_info["control_address"]
port_info = ray_tpu_torch.init(num_cpus=1)

@ray_tpu.remote
def where_ref():
    import os, sys
    return sys.modules["ray_tpu._private.core"].current_core().node_id

@ray_tpu_torch.remote
def where_port():
    import sys
    return sys.modules["ray_tpu_torch._private.core"].current_core().node_id

ref_nodes = [n["node_id"] for n in ray_tpu.nodes()]
port_nodes = [n["node_id"] for n in ray_tpu_torch.nodes()]
out = {
    "ref_addr": ref_info["control_address"],
    "port_addr": port_info["control_address"],
    "ref_nodes": ref_nodes, "port_nodes": port_nodes,
    "ref_task_node": ray_tpu.get(where_ref.remote(), timeout=60),
    "port_task_node": ray_tpu_torch.get(where_port.remote(), timeout=60),
    "ref_sessions": os.listdir("/dev/shm/ray_tpu"),
    "port_sessions": os.listdir("/dev/shm/ray_tpu_torch"),
}

# a compiled DAG in each runtime: each keeps its channels under its own
# session
from ray_tpu.dag import InputNode as RefInput
from ray_tpu_torch.dag import InputNode as PortInput

@ray_tpu.remote
class RefStage:
    def f(self, x):
        return x + 1

@ray_tpu_torch.remote
class PortStage:
    def f(self, x):
        return x + 2

with RefInput() as i:
    ref_dag = RefStage.remote().f.bind(i).experimental_compile()
with PortInput() as i:
    port_dag = PortStage.remote().f.bind(i).experimental_compile()
out["dag"] = [ref_dag.execute(1).get(timeout=60),
              port_dag.execute(1).get(timeout=60),
              ref_dag._chan_dir, port_dag._chan_dir]
ref_dag.teardown()
port_dag.teardown()
import ray_tpu.scripts.cli as ref_cli
import ray_tpu_torch.scripts.cli as port_cli
out["cluster_files"] = [ref_cli.CLUSTER_FILE, port_cli.cluster_file(),
                        port_cli.CLUSTER_FILE_ENV]
ray_tpu_torch.shutdown()
ray_tpu.shutdown()
del os.environ["RAY_TPU_ADDRESS"]
# and the reverse: the port's variable names a port cluster the reference
# must not attach to
port_info = ray_tpu_torch.init(num_cpus=1)
os.environ["RAY_TPU_TORCH_ADDRESS"] = port_info["control_address"]
ref_info = ray_tpu.init(num_cpus=1)
out["reverse"] = [ref_info["control_address"],
                  port_info["control_address"],
                  [n["node_id"] for n in ray_tpu.nodes()],
                  [n["node_id"] for n in ray_tpu_torch.nodes()]]
ray_tpu.shutdown()
ray_tpu_torch.shutdown()
print("RESULT " + json.dumps(out))
"""


def test_two_runtimes_on_one_host_stay_apart():
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    for var in ("RAY_TPU_ADDRESS", "RAY_TPU_TORCH_ADDRESS",
                "RAY_TPU_CLUSTER_FILE", "RAY_TPU_TORCH_CLUSTER_FILE"):
        env.pop(var, None)
    out = subprocess.run([sys.executable, "-c", _TWO_RUNTIMES], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads([ln for ln in out.stdout.splitlines()
                    if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert r["ref_addr"] != r["port_addr"]
    assert len(r["ref_nodes"]) == 1 and len(r["port_nodes"]) == 1
    assert not set(r["ref_nodes"]) & set(r["port_nodes"])
    assert r["ref_task_node"] in r["ref_nodes"]
    assert r["port_task_node"] in r["port_nodes"]
    # each session lives under its own root
    assert r["port_sessions"] and r["ref_sessions"]
    assert not set(r["port_sessions"]) & set(
        s for s in r["ref_sessions"] if s.startswith("session-"))
    ref_addr, port_addr, ref_nodes, port_nodes = r["reverse"]
    assert ref_addr != port_addr
    assert not set(ref_nodes) & set(port_nodes)
    # compiled DAGs' shm channels live under each runtime's own root
    ref_out, port_out, ref_chans, port_chans = r["dag"]
    assert (ref_out, port_out) == (2, 3)
    assert ref_chans.startswith("/dev/shm/ray_tpu/session-")
    assert port_chans.startswith("/dev/shm/ray_tpu_torch/session-")
    # and the CLI-started clusters write their own cluster files
    ref_file, port_file, port_env = r["cluster_files"]
    assert ref_file != port_file
    assert port_file == "/tmp/ray_tpu_torch/ray_current_cluster.json"
    assert port_env == "RAY_TPU_TORCH_CLUSTER_FILE"


def test_native_builds_and_session_roots_are_apart():
    from ray_tpu.native import build as ref_build
    from ray_tpu_torch.native import build as port_build
    from ray_tpu._private import bootstrap as ref_boot
    from ray_tpu_torch._private import bootstrap as port_boot

    assert ref_build._BUILD_DIR != port_build._BUILD_DIR
    assert port_build._BUILD_DIR.endswith(
        os.path.join("ray_tpu_torch", "_build", "native"))
    assert ref_boot._SESSION_ROOT != port_boot._SESSION_ROOT
    assert rt.ADDRESS_ENV == "RAY_TPU_TORCH_ADDRESS"


# -- GPT nano in a CPU actor against ray_tpu's gpt.apply ---------------------


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


@rt.remote
class GPTActor:
    def __init__(self, np_params, recipe):
        torch.set_num_threads(1)
        from ray_tpu_torch.models import convert, gpt

        self.cfg = gpt.GPTConfig.nano(dtype=torch.float32, **recipe)
        self.params = convert.from_jax_params(np_params, self.cfg,
                                              device="cpu")

    def apply(self, tokens):
        import sys

        from ray_tpu_torch.models import gpt

        assert not any(m == "jax" or m.startswith(("jax.", "ray_tpu."))
                       for m in sys.modules)
        return gpt.apply(self.params, tokens, self.cfg, device="cpu")


RECIPES = {
    "learned-ln-gelu": dict(pos="learned", norm="ln", act="gelu"),
    "rope-rms-swiglu": dict(pos="rope", norm="rms", act="swiglu"),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_gpt_actor_matches_jax_apply(cluster, recipe):
    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import convert, gpt

    kw = RECIPES[recipe]
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32, **kw)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tokens = np.random.RandomState(0).randint(0, 256, (2, 48))
    ref = np.asarray(jgpt.apply(jparams, jnp.asarray(tokens), jcfg))
    actor = GPTActor.remote(np_params, kw)
    out = rt.get(actor.apply.remote(torch.from_numpy(tokens)), timeout=2 * T)
    assert out.shape == (2, 48, 256) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    # and the same forward in this process, on the same converted weights
    tcfg = gpt.GPTConfig.nano(dtype=torch.float32, **kw)
    local = gpt.apply(convert.from_jax_params(np_params, tcfg, device="cpu"),
                      tokens, tcfg, device="cpu")
    np.testing.assert_allclose(out.numpy(), local.numpy(), atol=1e-5, rtol=0)
    rt.kill(actor)
