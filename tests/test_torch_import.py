"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package (its models, MoE, ResNet and the GPT-2
checkpoint converter among them, which loads no ``transformers``
either, and its RL library, A.8b's algorithms, replay buffer and offline
data too), its runtime modules load no torch either (nor
do its compiled DAGs, its CLI, jobs, state API and client mode, even
while a DAG channel carries values that are not tensors), its
entry points refuse to fall back to the CPU silently (an NCCL collective
group with no card raises), the kv collective backend runs on the port's
own runtime, its Train layer (``ray_tpu_torch.train``, with elastic and
the placement groups), its Data library (``ray_tpu_torch.data``), its
autoscaler and the rest of ``util`` load neither torch nor the JAX
package, nor do its analyzers, Tune and AIR (``ray_tpu_torch.analysis``,
``tune``, ``air``), and its sources call no library attention and no
torch.compile."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ray_tpu_torch"

_PROBE = r"""
import sys
import ray_tpu_torch
import ray_tpu_torch.ops
import ray_tpu_torch.ops._kernels
import ray_tpu_torch.models.gpt as gpt
import ray_tpu_torch.models.convert
import ray_tpu_torch.models.training as training
import ray_tpu_torch.models.moe as moe
import ray_tpu_torch.models.resnet as resnet
import ray_tpu_torch.models.hf as hf
import ray_tpu_torch.ops.moe
from ray_tpu_torch.models import MoEConfig, ResNetConfig
import ray_tpu_torch.serve
import ray_tpu_torch.ops.quantize as quantize
import ray_tpu_torch.collective as collective
import ray_tpu_torch.collective.compression
import ray_tpu_torch.collective.nccl_group
import ray_tpu_torch.collective.peer_memory
import ray_tpu_torch.parallel as parallel
import ray_tpu_torch.parallel.sharding
import ray_tpu_torch.rl as rl
import ray_tpu_torch.rl.algorithms.algorithm
import ray_tpu_torch.rl.algorithms.appo
import ray_tpu_torch.rl.algorithms.cql
import ray_tpu_torch.rl.algorithms.dqn
import ray_tpu_torch.rl.algorithms.dreamerv3
import ray_tpu_torch.rl.algorithms.impala
import ray_tpu_torch.rl.algorithms.marwil
import ray_tpu_torch.rl.algorithms.multi_agent_ppo
import ray_tpu_torch.rl.algorithms.ppo
import ray_tpu_torch.rl.algorithms.sac
import ray_tpu_torch.rl.connectors.connector
import ray_tpu_torch.rl.connectors.env_to_module
import ray_tpu_torch.rl.connectors.module_to_env
import ray_tpu_torch.rl.core.learner
import ray_tpu_torch.rl.core.multi_rl_module
import ray_tpu_torch.rl.core.rl_module
import ray_tpu_torch.rl.env.env_runner
import ray_tpu_torch.rl.env.jax_env
import ray_tpu_torch.rl.env.multi_agent_env
import ray_tpu_torch.rl.podracer
import ray_tpu_torch.rl.offline
import ray_tpu_torch.rl.offline.offline_data
import ray_tpu_torch.rl.utils.replay_buffer
from ray_tpu_torch.rl import (DQNConfig, SACConfig, CQLConfig, MARWILConfig,
                              BCConfig, DreamerV3Config, ReplayBuffer,
                              OfflineData, record_rollouts)
import torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ray_tpu" or m.startswith("ray_tpu."))
assert not bad, bad
assert "transformers" not in sys.modules
cfg = gpt.GPTConfig.nano()
params = gpt.init(cfg, seed=0, device="cpu")
for call in (lambda: gpt.apply(params, [[1, 2, 3]], cfg),
             lambda: gpt.init(cfg),
             lambda: gpt.generate(params, cfg, [[1, 2]], 2),
             lambda: gpt.loss_fn(params, {"tokens": [[1, 2, 3]]}, cfg),
             lambda: training.make_train_step(cfg),
             lambda: training.make_eval_step(cfg),
             lambda: moe.init(MoEConfig.mixtral_nano()),
             lambda: moe.apply(moe.init(MoEConfig.mixtral_nano(),
                                        device="cpu"), [[1, 2]],
                               MoEConfig.mixtral_nano()),
             lambda: resnet.init(ResNetConfig.tiny()),
             lambda: hf.from_hf_gpt2({}, config={}),
             lambda: rl.run_anakin(rl.AnakinConfig(num_updates=1)),
             lambda: rl.PPOConfig().environment("CartPole-v1").build(),
             lambda: rl.DQNConfig().environment("CartPole-v1").build(),
             lambda: rl.SACConfig().environment("Pendulum-v1").build(),
             lambda: rl.DreamerV3Config().environment("CartPole-v1").build(),
             lambda: rl.make_impala_learner({"obs_dim": 4,
                                             "num_actions": 2}),
             lambda: collective.init_collective_group(1, 0, backend="nccl")):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("ran without a device and without CUDA")
import torch.distributed as dist
assert not dist.is_initialized()
ray_tpu_torch.init(num_cpus=1)
try:
    collective.init_collective_group(1, 0, backend="kv", group_name="p")
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(collective.allreduce(x, "p"), x)
    collective.destroy_collective_group("p", timeout=30)
finally:
    ray_tpu_torch.shutdown()
assert not dist.is_initialized()
print("ok")
"""

_RUNTIME_PROBE = r"""
import sys
import ray_tpu_torch
import ray_tpu_torch._private.accelerators
import ray_tpu_torch._private.api
import ray_tpu_torch._private.bootstrap
import ray_tpu_torch._private.control
import ray_tpu_torch._private.core
import ray_tpu_torch._private.node
import ray_tpu_torch._private.serialization
import ray_tpu_torch._private.worker_proc
import ray_tpu_torch.native.sched
import ray_tpu_torch.util.tracing
import ray_tpu_torch.dag
import ray_tpu_torch.elastic.preemption
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch"))
assert not bad, bad
print("ok")
"""


def test_import_loads_no_jax_and_no_cpu_fallback():
    # hide any GPU so "no device given" must raise
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_runtime_modules_load_no_torch_and_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _RUNTIME_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _torch_compile_uses(tree):
    """The lines where a module reaches torch's ``compile``, however it
    is imported (``from torch import compile as c``, ``import torch as
    t`` then ``t.compile``)."""
    torch_names, lines = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" and a.asname:
                    torch_names.add(a.asname)
                elif a.asname is None and a.name.split(".")[0] == "torch":
                    torch_names.add("torch")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            lines += [node.lineno for a in node.names if a.name == "compile"]
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "compile" \
                and isinstance(node.value, ast.Name) \
                and node.value.id in torch_names:
            lines.append(node.lineno)
    return sorted(lines)


def test_sources_use_no_library_attention_or_jax():
    # the analyzers' fixtures are parsed, never imported or run: the torch
    # lint's fixture seeds torch.compile bodies, so they may name it
    fixtures = PORT / "analysis" / "fixtures"
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                        r"flash_attn|^\s*(import|from)\s+(jax|ray_tpu)\b",
                        re.M)
    banned_in_fixtures = re.compile(
        r"scaled_dot_product_attention|flash_attn|"
        r"^\s*(import|from)\s+(jax|ray_tpu)\b", re.M)
    assert _torch_compile_uses(ast.parse(
        "from torch import compile as c\nimport torch as t\n"
        "f = t.compile(c(g))\n")) == [1, 3]
    assert _torch_compile_uses(
        ast.parse((fixtures / "fx_torch_purity.py").read_text()))
    files = list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu"))
    assert files
    for f in files:
        fixture = fixtures in f.parents
        text = f.read_text()
        hits = (banned_in_fixtures if fixture else banned).findall(text)
        assert not hits, (f, hits)
        if f.suffix == ".py" and not fixture:
            assert not _torch_compile_uses(ast.parse(text)), f
    for script in ("chip_smoke.py", "chip_studies.py"):
        text = (REPO / script).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|ray_tpu)\b", text,
                             re.M), script


_SERVE_PROBE = r"""
import sys
import ray_tpu_torch.serve as serve
import ray_tpu_torch.serve._asgi
import ray_tpu_torch.serve._common
import ray_tpu_torch.serve._controller
import ray_tpu_torch.serve._deployment
import ray_tpu_torch.serve._grpc
import ray_tpu_torch.serve._handle
import ray_tpu_torch.serve._proxy
import ray_tpu_torch.serve._replica
import ray_tpu_torch.serve._router
import ray_tpu_torch.serve.api
import ray_tpu_torch.serve.batching
import ray_tpu_torch.serve.llm
import ray_tpu_torch.serve.multiplex
import ray_tpu_torch.serve.schema
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch",
                                    "aiohttp", "grpc", "yaml"))
assert not bad, bad
assert "ray_tpu_torch.serve._engine" not in sys.modules
# the engine exports resolve on first use, and only then load torch
assert serve.ContinuousEngine.__module__ == "ray_tpu_torch.serve._engine"
assert "torch" in sys.modules
print("ok")
"""

SERVE_MODULES = ("__init__", "_common", "_deployment", "batching", "_replica",
                 "multiplex", "_router", "_handle", "_controller", "api",
                 "_asgi", "_proxy", "_grpc", "schema", "llm")


def test_serve_modules_load_no_torch_and_no_jax():
    """The controller, router, proxy and api workers import Serve; none
    of it loads torch (nor JAX, nor the optional HTTP/gRPC/YAML
    packages) until a replica builds a model."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_serve_holds_its_modules_and_imports_nothing_of_the_reference():
    serve_dir = PORT / "serve"
    have = {p.stem for p in serve_dir.glob("*.py")}
    assert set(SERVE_MODULES) | {"_engine"} == have
    ref = re.compile(r"(^\s*(import|from)\s+(jax|ray_tpu)\b)"
                     r"|import_module\(\s*['\"](jax|ray_tpu)\b", re.M)
    for f in sorted(serve_dir.glob("*.py")):
        assert not ref.search(f.read_text()), f


_TRAIN_PROBE = r"""
import sys
import ray_tpu_torch.train as train
import ray_tpu_torch.train.backend
import ray_tpu_torch.train.backend_executor
import ray_tpu_torch.train.checkpoint
import ray_tpu_torch.train.checkpoint_manager
import ray_tpu_torch.train.config
import ray_tpu_torch.train.result
import ray_tpu_torch.train.session
import ray_tpu_torch.train.storage
import ray_tpu_torch.train.torch
import ray_tpu_torch.train.trainer
import ray_tpu_torch.train.worker_group
import ray_tpu_torch.elastic.config
import ray_tpu_torch.elastic.emergency
import ray_tpu_torch.elastic.resume
import ray_tpu_torch.util.placement_group
import ray_tpu_torch.util.scheduling_strategies
import ray_tpu_torch._private.fileio
for name in train.__all__:
    getattr(train, name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch"))
assert not bad, bad
print("ok")
"""

TRAIN_MODULES = ("__init__", "backend", "backend_executor", "checkpoint",
                 "checkpoint_manager", "config", "result", "session",
                 "storage", "torch", "trainer", "worker_group")


def test_train_modules_load_no_torch_and_no_jax():
    """The driver and the control plane import Train; no module of it (nor
    its exports, nor elastic's, placement groups, file IO) loads torch or
    anything of the JAX package: only a train loop that builds a model
    does."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    have = {p.stem for p in (PORT / "train").glob("*.py")}
    assert have == set(TRAIN_MODULES)


_DATA_PROBE = r"""
import sys
import ray_tpu_torch.data as data
import ray_tpu_torch.data._avro
import ray_tpu_torch.data.aggregate
import ray_tpu_torch.data.block
import ray_tpu_torch.data.compute
import ray_tpu_torch.data.context
import ray_tpu_torch.data.dataset
import ray_tpu_torch.data.datasource
import ray_tpu_torch.data.execution
import ray_tpu_torch.data.external
import ray_tpu_torch.data.grouped
import ray_tpu_torch.data.iterator
import ray_tpu_torch.data.lake
import ray_tpu_torch.data.logical
import ray_tpu_torch.data.preprocessors
import ray_tpu_torch.train.trainer
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch"))
assert not bad, bad
print("ok")
"""

DATA_MODULES = ("__init__", "_avro", "aggregate", "block", "compute",
                "context", "dataset", "datasource", "execution", "external",
                "grouped", "iterator", "lake", "logical", "preprocessors")


def test_data_modules_load_no_torch_and_no_jax():
    """Read tasks and the split coordinator run on CPU workers, which come
    up in a fraction of the time a worker that imports torch takes: no
    module of the port's Data (nor the trainer that shards datasets)
    loads torch, JAX or the JAX package; only the functions that make
    tensors import torch."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _DATA_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    have = {p.stem for p in (PORT / "data").glob("*.py")}
    assert have == set(DATA_MODULES)
    assert have == {p.stem for p in (REPO / "ray_tpu" / "data").glob("*.py")}


_CLI_PROBE = r"""
import sys, tempfile, os
import ray_tpu_torch.dag as dag
import ray_tpu_torch.dag.channel
import ray_tpu_torch.dag.collective
import ray_tpu_torch.dag.compiled_dag
import ray_tpu_torch.dag.dag_node
import ray_tpu_torch.experimental
import ray_tpu_torch.experimental.internal_kv
import ray_tpu_torch.job
import ray_tpu_torch.job.job_manager
import ray_tpu_torch.scripts.cli as cli
import ray_tpu_torch.util.client
import ray_tpu_torch.util.client.client_core
import ray_tpu_torch.util.client.server
import ray_tpu_torch.util.state
import ray_tpu_torch.util.state.api
import numpy as np
for name in dag.__all__:
    getattr(dag, name)
# a channel carrying values that are not tensors loads no torch
path = os.path.join(tempfile.mkdtemp(), "chan")
c = dag.Channel(path, nslots=2)
c.write({"a": np.arange(4)})
assert c.read(timeout_s=10)[1]["a"].sum() == 6
c.release()
cli.build_parser().parse_args(["status"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch"))
assert not bad, bad
print("ok")
"""

CLI_MODULES = {
    "dag": ("__init__", "channel", "collective", "compiled_dag",
            "dag_node"),
    "experimental": ("__init__", "internal_kv", "tqdm_ray"),
    "job": ("__init__", "job_manager"),
    "scripts": ("__init__", "cli"),
    "util/client": ("__init__", "client_core", "server"),
    "util/state": ("__init__", "api"),
}


def test_dag_cli_job_state_client_load_no_torch_and_no_jax():
    """A compiled DAG's exec loop runs in any actor, the CLI, the job
    supervisor and the client server in processes that compute nothing:
    none of their modules loads torch, JAX or the JAX package, and a DAG
    channel loads torch only for a tensor."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _CLI_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for pkg, mods in CLI_MODULES.items():
        have = {p.stem for p in (PORT / pkg).glob("*.py")}
        assert have == set(mods), (pkg, have)
    # the CLI's own process loads no torch either
    cli = subprocess.run(
        [sys.executable, "-c", "import sys, runpy; sys.argv = ['x', "
         "'config']; runpy.run_module('ray_tpu_torch', run_name="
         "'__main__'); assert 'torch' not in sys.modules, 'torch'"],
        cwd="/", env=env, capture_output=True, text=True, timeout=120)
    assert cli.returncode == 0, cli.stderr


_AUTOSCALER_PROBE = r"""
import sys
import ray_tpu_torch.autoscaler as autoscaler
import ray_tpu_torch.autoscaler.autoscaler
import ray_tpu_torch.autoscaler.node_provider
import ray_tpu_torch.autoscaler.v2
import ray_tpu_torch.util as util
import ray_tpu_torch.util.actor_pool
import ray_tpu_torch.util.dask
import ray_tpu_torch.util.iter
import ray_tpu_torch.util.joblib
import ray_tpu_torch.util.multiprocessing
import ray_tpu_torch.util.queue
import ray_tpu_torch.util.rpdb
import ray_tpu_torch.util.spark
import ray_tpu_torch.util.metrics
import ray_tpu_torch.experimental.tqdm_ray
import ray_tpu_torch._private.swarm
for mod in (autoscaler, util):
    for name in mod.__all__:
        getattr(mod, name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch",
                                    "yaml", "joblib", "kubernetes"))
assert not bad, bad
print("ok")
"""

AUTOSCALER_MODULES = {
    "autoscaler": ("__init__", "autoscaler", "node_provider", "v2"),
    "util": ("__init__", "actor_pool", "dask", "iter", "joblib",
             "metrics", "multiprocessing", "placement_group", "queue",
             "rpdb", "scheduling_strategies", "spark", "tracing"),
}


def test_autoscaler_and_util_load_no_torch_and_no_jax():
    """The autoscaler's monitor, the queue actor, pool and shard actors and
    the spark shim run in processes that compute nothing on a card: none
    of the autoscaler's modules, nor the rest of ``util``,
    ``experimental.tqdm_ray`` and the swarm, loads torch, JAX, the JAX
    package or an optional package (yaml, joblib, kubernetes) at import;
    each directory holds the reference's modules."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _AUTOSCALER_PROBE],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for pkg, mods in AUTOSCALER_MODULES.items():
        have = {p.stem for p in (PORT / pkg).glob("*.py")}
        assert have == set(mods), (pkg, have)
        ref = {p.stem for p in (REPO / "ray_tpu" / pkg).glob("*.py")}
        assert have <= ref, (pkg, have - ref)
    assert set(AUTOSCALER_MODULES["util"]) == \
        {p.stem for p in (REPO / "ray_tpu" / "util").glob("*.py")}


_TELEMETRY_PROBE = r"""
import sys
import ray_tpu_torch.telemetry as telemetry
import ray_tpu_torch.telemetry.aggregator
import ray_tpu_torch.telemetry.config
import ray_tpu_torch.telemetry.device
import ray_tpu_torch.telemetry.goodput
import ray_tpu_torch.telemetry.recorder
import ray_tpu_torch.telemetry.timeline
import ray_tpu_torch.telemetry.trace_assembly
import ray_tpu_torch.util.metrics
import ray_tpu_torch.elastic.remediation
import ray_tpu_torch.dashboard
import ray_tpu_torch.dashboard.head
import ray_tpu_torch.dashboard.static
for name in telemetry.__all__:
    getattr(telemetry, name)
# the fence, the census and the ledger's hooks read torch only where the
# process already has it: with none loaded they are no-ops
telemetry.recorder._fence({"a": [1, 2.0]})
live = telemetry.device.DeviceMemoryCensus().census()["live"]
assert live["total_bytes"] == 0 and live["allocator"] == {}, live
telemetry.device.get_ledger().record_build("x.cu", 0.1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch",
                                    "numpy"))
assert not bad, bad
print("ok")
"""

TELEMETRY_MODULES = {
    "telemetry": ("__init__", "aggregator", "config", "device", "goodput",
                  "recorder", "timeline", "trace_assembly"),
    "dashboard": ("__init__", "head", "static"),
}


def test_telemetry_metrics_remediation_dashboard_load_no_torch_and_no_jax():
    """The dashboard's head process and the autoscaler's monitor compute
    nothing on a card: ``telemetry/``, ``util.metrics``,
    ``elastic.remediation`` and ``dashboard/`` load neither torch, JAX,
    the JAX package nor numpy at import, and each directory holds the
    reference's modules."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _TELEMETRY_PROBE], cwd="/",
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for pkg, mods in TELEMETRY_MODULES.items():
        have = {p.stem for p in (PORT / pkg).glob("*.py")}
        ref = {p.stem for p in (REPO / "ray_tpu" / pkg).glob("*.py")}
        assert have == set(mods) == ref, (pkg, have, ref)


RL_MODULES = {
    "rl": ("__init__", "podracer"),
    "rl/core": ("__init__", "learner", "multi_rl_module", "rl_module"),
    "rl/env": ("__init__", "env_runner", "jax_env", "multi_agent_env"),
    "rl/connectors": ("__init__", "connector", "env_to_module",
                      "module_to_env"),
    "rl/algorithms": ("__init__", "algorithm", "appo", "cql", "dqn",
                      "dreamerv3", "impala", "marwil", "multi_agent_ppo",
                      "ppo", "sac"),
    "rl/offline": ("__init__", "offline_data"),
    "rl/utils": ("__init__", "replay_buffer"),
}


def test_rl_holds_the_reference_modules_of_a8a():
    """``ray_tpu_torch/rl`` holds ROADMAP A.8a's modules and, since
    A.8b, the rest of the reference's ``rl/``: every module of it, and
    none imports anything of the reference or JAX."""
    ref = re.compile(r"(^\s*(import|from)\s+(jax|ray_tpu)\b)"
                     r"|import_module\(\s*['\"](jax|ray_tpu)\b", re.M)
    for pkg, mods in RL_MODULES.items():
        have = {p.stem for p in (PORT / pkg).glob("*.py")}
        assert have == set(mods), (pkg, have)
        theirs = {p.stem for p in (REPO / "ray_tpu" / pkg).glob("*.py")}
        assert have <= theirs, (pkg, have - theirs)
        assert have == theirs, (pkg, theirs - have)
        for f in (PORT / pkg).glob("*.py"):
            assert not ref.search(f.read_text()), f
    theirs = {str(p.parent.relative_to(REPO / "ray_tpu"))
              for p in (REPO / "ray_tpu" / "rl").rglob("*.py")}
    assert theirs == set(RL_MODULES), theirs ^ set(RL_MODULES)
    import ray_tpu_torch.rl as rl

    assert not hasattr(rl, "NOT_PORTED")


_ANALYSIS_TUNE_AIR_PROBE = r"""
import sys
import ray_tpu_torch.analysis as analysis
import ray_tpu_torch.analysis._model
import ray_tpu_torch.analysis.baseline
import ray_tpu_torch.analysis.blocking_async
import ray_tpu_torch.analysis.guarded_by
import ray_tpu_torch.analysis.lock_order
import ray_tpu_torch.analysis.torch_purity
import ray_tpu_torch.tune as tune
import ray_tpu_torch.tune.schedulers
import ray_tpu_torch.tune.search
import ray_tpu_torch.tune.trial
import ray_tpu_torch.tune.tune_controller
import ray_tpu_torch.tune.tuner
import ray_tpu_torch.air as air
import ray_tpu_torch.air.integrations
import ray_tpu_torch.air.integrations.mlflow
import ray_tpu_torch.air.integrations.tbx
import ray_tpu_torch.air.integrations.wandb
from ray_tpu_torch.train import JaxTrainer
assert callable(JaxTrainer.as_trainable)
assert sorted(analysis.PASSES) == ["blocking_async", "guarded_by",
                                   "lock_order", "torch_purity"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch",
                                    "triton", "mlflow", "wandb"))
assert not bad, bad
print("ok")
"""

ANALYSIS_TUNE_AIR_MODULES = {
    "analysis": ("__init__", "_model", "baseline", "blocking_async",
                 "guarded_by", "lock_order", "torch_purity"),
    "analysis/fixtures": ("fx_blocking_async", "fx_budget_blocking",
                          "fx_guarded_by", "fx_lock_order",
                          "fx_torch_purity"),
    "tune": ("__init__", "schedulers", "search", "trial", "tune_controller",
             "tuner"),
    "air": ("__init__",),
    "air/integrations": ("__init__", "mlflow", "tbx", "wandb"),
}
# the reference's module -> the port's counterpart, where the names differ
_RENAMED = {"jax_purity": "torch_purity", "fx_jax_purity": "fx_torch_purity"}


def test_analysis_tune_air_load_no_torch_and_no_jax():
    """The analyzers (ROADMAP A.9), Tune and AIR (A.10a) load neither
    torch, JAX, the JAX package, Triton nor the optional tracking
    libraries at import; each directory holds the reference's modules,
    ``jax_purity`` and its fixture as ``torch_purity`` and
    ``fx_torch_purity``, and none imports anything of the reference."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _ANALYSIS_TUNE_AIR_PROBE],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    ref = re.compile(r"(^\s*(import|from)\s+(jax|ray_tpu)\b)"
                     r"|import_module\(\s*['\"](jax|ray_tpu)\b", re.M)
    for pkg, mods in ANALYSIS_TUNE_AIR_MODULES.items():
        have = {p.stem for p in (PORT / pkg).glob("*.py")}
        theirs = {_RENAMED.get(p.stem, p.stem)
                  for p in (REPO / "ray_tpu" / pkg).glob("*.py")}
        assert have == set(mods) == theirs, (pkg, have, theirs)
        for f in (PORT / pkg).glob("*.py"):
            assert not ref.search(f.read_text()), f
