"""Runtime environments: per-task/actor/job execution contexts.

Analog of the reference's runtime_env machinery (reference:
python/ray/_private/runtime_env/ — working_dir.py, py_modules.py,
packaging.py URI cache, plugin.py; agent materializes envs per node).
TPU-native simplifications: packages travel through the control-plane KV
(content-addressed zips) instead of a dedicated agent protocol, and
materialization happens lazily in the worker with a node-shared
content-addressed cache.

Supported fields:
  env_vars     {str: str}   applied around execution
  working_dir  path/zip     shipped, extracted, becomes cwd + sys.path[0]
  py_modules   [paths]      shipped, extracted, prepended to sys.path
  pip          [requirements]  content-addressed package env built once
               per node (pip install --target into the shared cache) and
               prepended to sys.path — the venv-equivalent for in-process
               workers (reference: runtime_env/pip.py builds a virtualenv
               and spawns the worker inside it; our workers already run,
               so the env is import-path scoped instead).  Gated: rejected
               unless RAY_TPU_TORCH_ALLOW_PKG_INSTALL=1.  With
               RAY_TPU_TORCH_WHEELHOUSE=<dir> the install is fully offline
               (--no-index --find-links), which is also how it is tested.
  uv           [requirements]  same content-addressed target-dir model
               as pip, installed by the `uv` binary (worker-local PATH /
               RAY_TPU_TORCH_UV_BIN, falling back to the driver's setting).
               Same gate and wheelhouse behavior as pip.
  conda        str (existing env NAME or PREFIX) or environment.yml-style
               dict (created once per content hash).  The env's
               site-packages is import-path scoped into the worker — the
               reference re-execs workers inside the env, so only
               ABI-compatible (same python minor) envs are accepted.
               Same RAY_TPU_TORCH_ALLOW_PKG_INSTALL gate.

pip/uv/conda are mutually exclusive, as in the reference.

The port's copy of ``ray_tpu/_private/runtime_env.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import sys
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

KV_NS = "runtime_env_packages"
CACHE_ROOT = os.environ.get("RAY_TPU_TORCH_RTENV_CACHE",
                            "/dev/shm/ray_tpu_torch/rtenv-cache")
from .config import cfg as _cfg

MAX_PACKAGE_BYTES = _cfg().rtenv_max_bytes
_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}

_lock = threading.Lock()
_materialized: Dict[str, str] = {}  # pkg hash -> extracted dir


def validate(env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    env = dict(env or {})
    unknown = set(env) - {"env_vars", "working_dir", "py_modules", "pip",
                          "uv", "conda", "config", "container", "image_uri"}
    if unknown:
        raise ValueError(f"unsupported runtime_env fields: {sorted(unknown)}")
    if env.get("image_uri"):
        # sugar (reference: runtime_env/image_uri.py ImageURIPlugin):
        # image_uri="img" == container={"image": "img"}
        if env.get("container"):
            raise ValueError("image_uri and container are mutually "
                             "exclusive (image_uri is shorthand)")
        env["container"] = {"image": env.pop("image_uri")}
    if sum(1 for k in ("pip", "uv", "conda") if env.get(k)) > 1:
        raise ValueError("pip, uv, and conda are mutually exclusive "
                         "(reference: runtime_env validation)")
    if env.get("pip") or env.get("uv") or env.get("conda"):
        if not _cfg().allow_pkg_install:
            raise ValueError(
                "runtime_env pip/uv/conda installs are disabled in this "
                "deployment (set RAY_TPU_TORCH_ALLOW_PKG_INSTALL=1 to enable)")
    c = env.get("container")
    if c:
        if not isinstance(c, dict) or not isinstance(c.get("image"), str) \
                or not c["image"]:
            raise ValueError("container must be {'image': str, "
                             "'run_options': [str, ...]?}")
        unknown_c = set(c) - {"image", "run_options", "runtime"}
        if unknown_c:
            raise ValueError(
                f"unsupported container fields: {sorted(unknown_c)}")
        if "runtime" in c and not isinstance(c["runtime"], str):
            raise ValueError("container runtime must be a string path")
        opts = c.get("run_options", [])
        if not isinstance(opts, (list, tuple)) or \
                not all(isinstance(o, str) for o in opts):
            # a bare string is an iterable of 1-char strings and would
            # splat into per-character argv entries downstream
            raise ValueError(
                "container run_options must be a list of strings")
        if env.get("pip") or env.get("uv") or env.get("conda"):
            raise ValueError("container excludes pip/uv/conda — bake "
                             "dependencies into the image (reference: "
                             "image_uri.py validation)")
        if not _cfg().allow_pkg_install:
            # image pulls are egress, gated exactly like pip installs
            raise ValueError(
                "container runtime_envs are disabled in this deployment "
                "(pulling images needs egress; set "
                "RAY_TPU_TORCH_ALLOW_PKG_INSTALL=1 to enable)")
    ev = env.get("env_vars") or {}
    if not all(isinstance(k, str) and isinstance(v, str)
               for k, v in ev.items()):
        raise ValueError("env_vars must be {str: str}")
    return env


def container_spec(env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The validated container spec of a prepared env (None when absent)."""
    return (env or {}).get("container") or None


def resolve_container_runtime(explicit: Optional[str] = None) -> str:
    """Container runtime resolution (reference: image_uri.py uses podman):
    explicit > RAY_TPU_TORCH_CONTAINER_RUNTIME > podman > docker on PATH; loud
    failure when none exists — a container env must never silently run
    un-containerized."""
    import shutil as _shutil

    for cand in (explicit, os.environ.get("RAY_TPU_TORCH_CONTAINER_RUNTIME")):
        if not cand:
            continue
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
        found = _shutil.which(cand)
        if found:
            return found
        # an EXPLICIT pin that doesn't resolve must fail, not silently
        # fall back to whatever podman/docker is on PATH (different
        # rootless/network semantics than the operator chose)
        raise RuntimeError(
            f"configured container runtime {cand!r} not found or not "
            "executable")
    for name in ("podman", "docker"):
        found = _shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "runtime_env requests a container but no container runtime was "
        "found (looked for RAY_TPU_TORCH_CONTAINER_RUNTIME, podman, docker)")


def wrap_container_cmd(cmd: List[str], env_delta: Dict[str, str],
                       spec: Dict[str, Any], session_dir: str,
                       pythonpath: str,
                       devices: List[str] = ()) -> List[str]:
    """Worker argv -> containerized argv (reference: image_uri.py:106
    _modify_context building the podman invocation).

    Host network (the worker dials the raylet/control on host TCP),
    host /dev/shm (the plasma arena lives there), the session dir and
    every PYTHONPATH entry mounted read-only, env via -e (the runtime
    does not forward its client's environment).  `devices` become
    --device grants — GPU actors get the /dev/nvidia* nodes."""
    runtime = resolve_container_runtime(spec.get("runtime"))
    args = [runtime, "run", "--rm", "--network=host", "--ipc=host",
            "-v", "/dev/shm:/dev/shm",
            "-v", f"{session_dir}:{session_dir}"]
    for dev in devices:
        args += [f"--device={dev}"]
    for entry in [p for p in pythonpath.split(os.pathsep) if p]:
        args += ["-v", f"{entry}:{entry}:ro"]
    env_delta = dict(env_delta, RAY_TPU_TORCH_IN_CONTAINER="1")
    for k, v in sorted(env_delta.items()):
        args += ["-e", f"{k}={v}"]
    args += list(spec.get("run_options", ()))
    args.append(spec["image"])
    return args + list(cmd)


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    base = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(base):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, base)
                try:
                    zf.write(full, rel)
                except OSError:
                    pass
        if not zf.namelist():
            zf.writestr(".empty", "")
    data = buf.getvalue()
    if len(data) > MAX_PACKAGE_BYTES:
        raise ValueError(f"runtime_env package {path!r} too large "
                         f"({len(data)} > {MAX_PACKAGE_BYTES} bytes)")
    return data


_upload_cache: Dict[Tuple[str, float], str] = {}  # (abspath, max mtime) -> uri


def _tree_mtime(path: str) -> float:
    latest = os.path.getmtime(path)
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
        for f in files:
            try:
                m = os.path.getmtime(os.path.join(root, f))
            except OSError:
                continue
            if m > latest:
                latest = m
    return latest


def _upload_package(control, path: str) -> str:
    """Zip a directory (or take a .zip file) and store it content-addressed
    in the control KV; returns 'pkg:<sha256>'.  Repeat submissions of an
    unchanged tree skip the re-zip via an (abspath, mtime) memo (the
    reference uploads once per job; packaging.py URI cache)."""
    if path.endswith(".zip") and os.path.isfile(path):
        with open(path, "rb") as f:
            data = f.read()
    elif os.path.isdir(path):
        key = (os.path.abspath(path), _tree_mtime(path))
        cached = _upload_cache.get(key)
        if cached is not None:
            return cached
        data = _zip_dir(path)
    else:
        raise ValueError(f"runtime_env path {path!r} is neither a "
                         f"directory nor a .zip file")
    digest = hashlib.sha256(data).hexdigest()
    uri = f"pkg:{digest}"
    if not control.call("kv_exists", {"ns": KV_NS, "key": uri},
                        timeout=30.0):
        control.call("kv_put", {"ns": KV_NS, "key": uri, "val": data},
                     timeout=120.0)
    if os.path.isdir(path):
        _upload_cache[(os.path.abspath(path), _tree_mtime(path))] = uri
    return uri


def prepare(env: Optional[Dict[str, Any]], control) -> Optional[Dict[str, Any]]:
    """Driver-side: validate + upload local dirs, returning a wire-safe
    env whose paths are pkg: URIs (reference: packaging.py upload path)."""
    if not env:
        return None
    env = validate(env)
    out = dict(env)
    wd = env.get("working_dir")
    if wd and not str(wd).startswith("pkg:"):
        out["working_dir"] = _upload_package(control, wd)
    mods = env.get("py_modules")
    if mods:
        out["py_modules"] = [m if str(m).startswith("pkg:")
                             else _upload_package(control, m) for m in mods]
    if env.get("pip") or env.get("uv"):
        # driver policy rides along so the worker installs the same way
        out["_wheelhouse"] = os.environ.get("RAY_TPU_TORCH_WHEELHOUSE")
    if env.get("uv"):
        out["_uv_bin"] = os.environ.get("RAY_TPU_TORCH_UV_BIN")
    if env.get("conda"):
        out["_conda_bin"] = os.environ.get("RAY_TPU_TORCH_CONDA_BIN")
    return out


def _build_target_env(kind: str, digest_material: str,
                      make_cmd) -> str:
    """Shared content-addressed build protocol for pip-style installers:
    digest-keyed dest under the node cache, build into tmp, marker file,
    atomic rename (loser of the race cleans up its tmp).  `make_cmd(tmp)`
    returns the argv installing into tmp."""
    import shutil
    import subprocess

    py = f"py{sys.version_info[0]}.{sys.version_info[1]}"
    digest = hashlib.sha256(
        (digest_material + "\0" + py).encode()).hexdigest()[:20]
    dest = os.path.join(CACHE_ROOT, f"{kind}env-{digest}")
    marker = os.path.join(dest, ".complete")
    if os.path.exists(marker):
        return dest
    tmp = dest + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    cmd = make_cmd(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"{kind} runtime_env build failed to run {cmd[0]!r}: "
            f"{e}") from e
    if proc.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"{kind} runtime_env build failed: {proc.stderr[-2000:]}")
    open(os.path.join(tmp, ".complete"), "w").close()
    try:
        os.rename(tmp, dest)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)  # another worker won
    return dest


def _build_pip_env(requirements: List[str],
                   wheelhouse: Optional[str]) -> str:
    """Build (once per node) a content-addressed package dir for a pip
    requirement list and return it for sys.path insertion (reference:
    runtime_env/pip.py — virtualenv keyed by the requirements hash with a
    node-shared cache).  ``pip install --target`` replaces the venv
    because our workers insert import paths instead of re-exec'ing."""
    reqs = sorted(str(r) for r in requirements)

    def make_cmd(tmp):
        cmd = [sys.executable, "-m", "pip", "install", "--quiet",
               "--target", tmp]
        if wheelhouse:
            # fully offline: wheels (and deps) come from the wheelhouse
            cmd += ["--no-index", "--find-links", wheelhouse]
        return cmd + reqs

    return _build_target_env("pip", "\n".join(reqs), make_cmd)


def _resolve_bin(explicit: Optional[str], env_var: str,
                 name: str) -> Optional[str]:
    """Installer-binary resolution, shared by uv and conda: the driver's
    explicit setting wins WHEN it is an executable on this node (a
    deliberate choice — also how tests inject stubs); a driver-local
    path absent from the worker image falls back to the worker's env
    var, then PATH."""
    import shutil as _shutil

    for cand in (explicit, os.environ.get(env_var), _shutil.which(name)):
        if not cand:
            continue
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
        found = _shutil.which(cand)
        if found:
            return found
    return None


def _build_uv_env(requirements: List[str],
                  wheelhouse: Optional[str],
                  uv_bin: Optional[str] = None) -> str:
    """uv-backed requirement install (reference: runtime_env/uv.py):
    same content-addressed target-dir model as pip, but resolved and
    installed by the `uv` binary (_resolve_bin precedence: driver's
    setting when runnable here, else worker env/PATH)."""
    uv = _resolve_bin(uv_bin, "RAY_TPU_TORCH_UV_BIN", "uv")
    if not uv:
        raise RuntimeError(
            "runtime_env {'uv': ...} requires the `uv` binary on PATH "
            "(or RAY_TPU_TORCH_UV_BIN); it is not installed in this image — "
            "use {'pip': ...} instead")
    reqs = sorted(str(r) for r in requirements)

    def make_cmd(tmp):
        cmd = [uv, "pip", "install", "--target", tmp,
               "--python", sys.executable]
        if wheelhouse:
            cmd += ["--no-index", "--find-links", wheelhouse]
        return cmd + reqs

    return _build_target_env("uv", "uv\0" + "\n".join(reqs), make_cmd)


def _conda_site_packages(prefix: str) -> str:
    """The env's site-packages dir, version-checked against THIS
    interpreter: our workers import the env in-place (the reference
    re-execs the worker inside the conda env; in-place import only
    works for an ABI-compatible python)."""
    import glob as _glob

    cands = sorted(_glob.glob(os.path.join(prefix, "lib", "python*",
                                           "site-packages")))
    if not cands:
        raise RuntimeError(
            f"conda env at {prefix!r} has no site-packages")
    want = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    for c in cands:
        if want in c:
            return c
    raise RuntimeError(
        f"conda env at {prefix!r} was built for "
        f"{os.path.basename(os.path.dirname(cands[0]))}, but workers run "
        f"{want}: packages would be ABI-incompatible.  Build the env on "
        f"{want} (the reference re-execs workers inside the env; this "
        f"runtime imports it in-place)")


def _build_conda_env(spec, conda_bin: Optional[str] = None) -> str:
    """Conda env support (reference: runtime_env/conda.py).

    spec forms:
      str  — the NAME or PREFIX of an existing conda env (resolved via
             `conda env list`-style prefix paths)
      dict — an environment.yml-style spec, created once per content
             hash with `conda env create`

    Returns the env's site-packages for sys.path insertion (see
    _conda_site_packages for the in-place-import caveat).  The binary
    comes from RAY_TPU_TORCH_CONDA_BIN or PATH; absent -> loud error."""
    import shutil as _shutil
    import subprocess

    conda = _resolve_bin(conda_bin, "RAY_TPU_TORCH_CONDA_BIN", "conda")
    if isinstance(spec, str) and os.path.isdir(spec):
        # an existing env PREFIX needs no conda binary at all
        return _conda_site_packages(spec)
    if not conda:
        raise RuntimeError(
            "runtime_env {'conda': ...} requires the `conda` binary on "
            "PATH (or RAY_TPU_TORCH_CONDA_BIN); it is not installed in this "
            "image — use {'pip': ...} instead")
    if isinstance(spec, str):
        # name of an existing env
        proc = subprocess.run(
            [conda, "env", "list", "--json"],
            capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            import json as _json

            for p in _json.loads(proc.stdout).get("envs", []):
                if os.path.basename(p) == spec:
                    return _conda_site_packages(p)
        raise RuntimeError(f"conda env {spec!r} not found")
    # dict spec: create once per content hash — into a tmp prefix with
    # an atomic rename, so concurrent creators (or a crash between
    # create and marker) can never destroy the winner's env
    import json as _json

    blob = _json.dumps(spec, sort_keys=True)
    digest = hashlib.sha256(blob.encode()).hexdigest()[:20]
    prefix = os.path.join(CACHE_ROOT, f"condaenv-{digest}")
    marker = os.path.join(prefix, ".complete")
    if not os.path.exists(marker):
        os.makedirs(CACHE_ROOT, exist_ok=True)
        tmp = prefix + f".tmp{os.getpid()}"
        spec_path = tmp + ".yml"
        with open(spec_path, "w") as f:
            import yaml as _yaml

            _yaml.safe_dump(spec, f)
        try:
            proc = subprocess.run(
                [conda, "env", "create", "--prefix", tmp,
                 "--file", spec_path],
                capture_output=True, text=True, timeout=1800)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            _shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"conda env create failed to run {conda!r}: {e}") from e
        if proc.returncode != 0:
            _shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"conda env create failed: {proc.stderr[-2000:]}")
        open(os.path.join(tmp, ".complete"), "w").close()
        try:
            os.rename(tmp, prefix)
        except OSError:
            _shutil.rmtree(tmp, ignore_errors=True)  # another worker won
    return _conda_site_packages(prefix)


def _fetch_package(control, uri: str) -> str:
    """Worker-side: extract pkg:<hash> into the shared cache; idempotent."""
    with _lock:
        got = _materialized.get(uri)
        if got:
            return got
    dest = os.path.join(CACHE_ROOT, uri.replace(":", "-"))
    marker = os.path.join(dest, ".complete")
    if not os.path.exists(marker):
        data = control.call("kv_get", {"ns": KV_NS, "key": uri},
                            timeout=120.0)
        if data is None:
            raise RuntimeError(f"runtime_env package {uri} missing from KV")
        tmp = dest + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(tmp)
        open(os.path.join(tmp, ".complete"), "w").close()
        try:
            os.rename(tmp, dest)
        except OSError:
            # another worker won the race
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    with _lock:
        _materialized[uri] = dest
    return dest


class Context:
    """Materialized environment, applied around execution."""

    def __init__(self, env_vars: Dict[str, str], sys_paths: List[str],
                 cwd: Optional[str]):
        self.env_vars = env_vars
        self.sys_paths = sys_paths
        self.cwd = cwd
        self._saved_env: Dict[str, Optional[str]] = {}
        self._saved_cwd: Optional[str] = None
        self._inserted_paths: List[str] = []

    def __enter__(self):
        for k, v in self.env_vars.items():
            self._saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        for p in reversed(self.sys_paths):
            if p not in sys.path:
                sys.path.insert(0, p)
                self._inserted_paths.append(p)
        if self.cwd:
            self._saved_cwd = os.getcwd()
            os.chdir(self.cwd)
        return self

    def __exit__(self, *exc):
        for k, old in self._saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        self._saved_env.clear()
        # drop our sys.path entries AND the modules imported from them so
        # a reused worker's later tasks don't see this env's packages
        # (sys.modules would otherwise cache them past the path removal)
        for p in self._inserted_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        if self._inserted_paths:
            prefixes = tuple(p + os.sep for p in self._inserted_paths)
            for mod_name, mod in list(sys.modules.items()):
                f = getattr(mod, "__file__", None)
                if f and f.startswith(prefixes):
                    del sys.modules[mod_name]
        self._inserted_paths.clear()
        if self._saved_cwd:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass
            self._saved_cwd = None
        return False

    def apply_permanent(self):
        """For actor processes: the env applies for the process lifetime."""
        self.__enter__()


def materialize(env: Optional[Dict[str, Any]], control) -> Context:
    """Worker-side: resolve pkg URIs and build an applicable Context
    (reference: the runtime_env agent's CreateRuntimeEnv)."""
    env = env or {}
    if env.get("container") and not os.environ.get("RAY_TPU_TORCH_IN_CONTAINER"):
        # containers wrap the WORKER LAUNCH (raylet-side, actors get a
        # dedicated wrapped worker); an in-process materialize cannot
        # retrofit one — reject loudly instead of running outside the
        # requested image
        raise RuntimeError(
            "container runtime_env reached a non-containerized worker: "
            "containers are applied at worker spawn and currently "
            "supported for ACTORS (which get a dedicated worker); plain "
            "tasks run on pooled workers — wrap the work in an actor")
    sys_paths: List[str] = []
    cwd = None
    wd = env.get("working_dir")
    if wd:
        cwd = _fetch_package(control, wd) if str(wd).startswith("pkg:") \
            else str(wd)
        sys_paths.append(cwd)
    for m in env.get("py_modules") or []:
        p = _fetch_package(control, m) if str(m).startswith("pkg:") else str(m)
        sys_paths.append(p)
    pip_reqs = env.get("pip")
    if pip_reqs:
        if isinstance(pip_reqs, dict):  # reference: {"packages": [...]}
            pip_reqs = pip_reqs.get("packages") or []
        sys_paths.append(_build_pip_env(list(pip_reqs),
                                        env.get("_wheelhouse")))
    uv_reqs = env.get("uv")
    if uv_reqs:
        if isinstance(uv_reqs, dict):  # reference: {"packages": [...]}
            uv_reqs = uv_reqs.get("packages") or []
        sys_paths.append(_build_uv_env(list(uv_reqs),
                                       env.get("_wheelhouse"),
                                       env.get("_uv_bin")))
    if env.get("conda"):
        sys_paths.append(_build_conda_env(env["conda"],
                                          env.get("_conda_bin")))
    return Context(dict(env.get("env_vars") or {}), sys_paths, cwd)
