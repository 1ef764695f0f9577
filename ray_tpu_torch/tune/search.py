"""Search spaces and search algorithms.

Mirrors the reference (reference: python/ray/tune/search/ — sample.py
domains, basic_variant.py BasicVariantGenerator, searcher.py Searcher ABC):
grid_search + random sampling domains expand into per-trial configs; a
Searcher proposes configs and learns from completed trials.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# Domains (reference: tune/search/sample.py)
# ---------------------------------------------------------------------------

class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


# ---------------------------------------------------------------------------
# Variant expansion (reference: tune/search/basic_variant.py)
# ---------------------------------------------------------------------------

def _walk(space: Dict[str, Any], path=()):
    """Yield (path, value) leaves of a nested dict."""
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set_path(d: Dict[str, Any], path, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: Optional[int] = None):
    """Expand grid axes (cross product) × num_samples random draws."""
    rng = random.Random(seed)
    leaves = list(_walk(param_space))
    grid_axes = [(p, v["grid_search"]) for p, v in leaves if _is_grid(v)]
    grids = itertools.product(*[vals for _, vals in grid_axes]) \
        if grid_axes else [()]
    for combo in grids:
        for _ in range(num_samples):
            cfg: Dict[str, Any] = {}
            for (p, v) in leaves:
                if _is_grid(v):
                    continue
                _set_path(cfg, p, v.sample(rng) if isinstance(v, Domain) else v)
            for (p, _), val in zip(grid_axes, combo):
                _set_path(cfg, p, val)
            yield cfg


# ---------------------------------------------------------------------------
# Searcher interface (reference: tune/search/searcher.py)
# ---------------------------------------------------------------------------

#: sentinel a searcher returns from suggest() to mean "nothing right now,
#: ask again later" (vs None = exhausted) — used by ConcurrencyLimiter
#: (reference: tune/search/concurrency_limiter.py returns None + retries)
DEFER = object()


class Searcher:
    DEFER = DEFER

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        # mode=None means "not explicitly set": Tuner backfills it from
        # TuneConfig (an explicit mode on an inner searcher of a
        # wrapper chain always wins); consumers treat None as "max"
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config, None when exhausted, or DEFER to retry later."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        pass


class BasicVariantGenerator(Searcher):
    """Grid/random search over a param_space."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self._variants = list(generate_variants(param_space, num_samples,
                                                seed))
        self._i = 0

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from a wrapped searcher (reference:
    tune/search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode or "max")
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return DEFER
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg is not DEFER:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error=error)


class Repeater(Searcher):
    """Runs each suggested config `repeat` times and reports the mean
    metric to the wrapped searcher (reference: tune/search/repeater.py —
    for noisy objectives)."""

    def __init__(self, searcher: Searcher, repeat: int = 3,
                 metric: Optional[str] = None):
        super().__init__(metric or searcher.metric, searcher.mode or "max")
        self.searcher = searcher
        self.repeat = repeat
        self._groups: Dict[str, List[str]] = {}   # lead trial id -> members
        self._member_of: Dict[str, str] = {}
        self._results: Dict[str, List[Dict[str, Any]]] = {}
        self._finished: Dict[str, set] = {}        # lead -> finished members
        self._queue: List[tuple] = []              # (lead, config) to repeat

    def suggest(self, trial_id: str):
        if self._queue:
            lead, cfg = self._queue.pop(0)
            self._groups[lead].append(trial_id)
            self._member_of[trial_id] = lead
            return dict(cfg)
        cfg = self.searcher.suggest(trial_id)
        if cfg is None or cfg is DEFER:
            return cfg
        self._groups[trial_id] = [trial_id]
        self._member_of[trial_id] = trial_id
        self._results[trial_id] = []
        for _ in range(self.repeat - 1):
            self._queue.append((trial_id, cfg))
        return dict(cfg)

    def on_trial_complete(self, trial_id, result=None, error=False):
        lead = self._member_of.get(trial_id, trial_id)
        if result is not None and not error:
            self._results.setdefault(lead, []).append(result)
        finished = self._finished.setdefault(lead, set())
        finished.add(trial_id)
        # finalize once every member (including errored ones) is done, with
        # whatever results survived — an errored member must not strand the
        # group and starve the wrapped searcher of the observation
        if len(finished) >= self.repeat:
            done = self._results.get(lead, [])
            if not done:
                self.searcher.on_trial_complete(lead, None, error=True)
                return
            metric = self.metric
            vals = [float(r[metric]) for r in done
                    if metric and metric in r]
            agg = dict(done[-1])
            if vals and metric:
                agg[metric] = sum(vals) / len(vals)
            self.searcher.on_trial_complete(lead, agg)


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator over a Domain param_space.

    Native model-based searcher standing in for the reference's
    hyperopt/optuna integrations (reference: tune/search/hyperopt/,
    tune/search/optuna/) without the external dependency: observations
    split into good/bad by quantile `gamma`; candidates are sampled from a
    KDE over the good set and ranked by the good/bad density ratio,
    independently per dimension.
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: Optional[str] = None, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, num_samples: int = 64,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        import numpy as np

        # modeled dims: Float/Integer/Categorical.  Everything else passes
        # through: Function domains get re-sampled each suggest, plain
        # constants are copied verbatim.
        self.space: Dict[str, Domain] = {}
        self._passthrough: Dict[str, Any] = {}
        for k, v in param_space.items():
            if isinstance(v, (Float, Integer, Categorical)):
                self.space[k] = v
            else:
                self._passthrough[k] = v
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.remaining = num_samples
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self._obs: List[tuple] = []   # (config, score)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def suggest(self, trial_id: str):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        if len(self._obs) < self.n_initial:
            cfg = {k: d.sample(self.rng) for k, d in self.space.items()}
        else:
            cfg = self._tpe_suggest()
        self._pending[trial_id] = cfg
        out = dict(cfg)
        for k, v in self._passthrough.items():
            out[k] = v.sample(self.rng) if isinstance(v, Domain) else v
        return out

    def _tpe_suggest(self) -> Dict[str, Any]:
        import numpy as np

        obs = sorted(self._obs, key=lambda o: o[1], reverse=True)
        n_good = max(2, int(len(obs) * self.gamma))
        good, bad = obs[:n_good], obs[n_good:] or obs[-2:]
        out = {}
        for k, dom in self.space.items():
            if isinstance(dom, Categorical):
                # weighted by category counts in the good set (+1 smooth)
                counts = {c: 1.0 for c in dom.categories}
                for cfg, _ in good:
                    if cfg.get(k) in counts:
                        counts[cfg[k]] += 1.0
                cats, w = zip(*counts.items())
                w = np.asarray(w) / sum(w)
                out[k] = cats[self.np_rng.choice(len(cats), p=w)]
                continue
            log = isinstance(dom, Float) and dom.log
            xform = (lambda v: float(np.log(v))) if log else float
            inv = (lambda v: float(np.exp(v))) if log else float
            gv = np.asarray([xform(cfg[k]) for cfg, _ in good])
            bv = np.asarray([xform(cfg[k]) for cfg, _ in bad])
            lo, hi = xform(dom.lower), xform(dom.upper)
            bw = max((hi - lo) / 10.0, 1e-6)

            def kde(x, pts):
                d = (x[:, None] - pts[None, :]) / bw
                return np.exp(-0.5 * d * d).sum(axis=1) / max(len(pts), 1)

            cand = gv[self.np_rng.randint(0, len(gv), self.n_candidates)] \
                + self.np_rng.randn(self.n_candidates) * bw
            cand = np.clip(cand, lo, hi)
            ratio = (kde(cand, gv) + 1e-12) / (kde(cand, bv) + 1e-12)
            best = inv(cand[int(np.argmax(ratio))])
            if isinstance(dom, Integer):
                best = int(round(best))
                best = min(max(best, dom.lower), dom.upper - 1)
            out[k] = best
        return out

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((cfg, score))


class BayesOptSearch(Searcher):
    """Gaussian-process Bayesian optimization over Float/Integer domains.

    Native stand-in for the reference's bayes_opt integration
    (reference: tune/search/bayesopt/bayesopt_search.py) without the
    external dependency: an RBF-kernel GP posterior over normalized
    [0,1]^d inputs, maximizing Expected Improvement over random
    candidates.  Categorical dims fall back to good-set-weighted
    sampling (a GP has no natural metric there).
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: Optional[str] = None, n_initial: int = 6,
                 n_candidates: int = 256, num_samples: int = 64,
                 length_scale: float = 0.2, noise: float = 1e-4,
                 xi: float = 0.01, seed: Optional[int] = None):
        super().__init__(metric, mode)
        import numpy as np

        self.space: Dict[str, Domain] = {}
        self._cats: Dict[str, Categorical] = {}
        self._passthrough: Dict[str, Any] = {}
        for k, v in param_space.items():
            if isinstance(v, (Float, Integer)):
                self.space[k] = v
            elif isinstance(v, Categorical):
                self._cats[k] = v
            else:
                self._passthrough[k] = v
        if not self.space:
            raise ValueError(
                "BayesOptSearch needs at least one Float/Integer dimension")
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.remaining = num_samples
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self._obs: List[tuple] = []   # (unit-vector, cat-config, score)
        self._pending: Dict[str, tuple] = {}

    # -- unit-cube transform -------------------------------------------------

    def _to_unit(self, dom: Domain, v: float) -> float:
        import numpy as np

        if isinstance(dom, Float) and dom.log:
            lo, hi = np.log(dom.lower), np.log(dom.upper)
            return float((np.log(v) - lo) / (hi - lo))
        lo, hi = float(dom.lower), float(dom.upper)
        return (float(v) - lo) / (hi - lo)

    def _from_unit(self, dom: Domain, u: float):
        import numpy as np

        u = min(max(u, 0.0), 1.0)
        if isinstance(dom, Float) and dom.log:
            lo, hi = np.log(dom.lower), np.log(dom.upper)
            return float(np.exp(lo + u * (hi - lo)))
        lo, hi = float(dom.lower), float(dom.upper)
        v = lo + u * (hi - lo)
        if isinstance(dom, Integer):
            return min(max(int(round(v)), dom.lower), dom.upper - 1)
        return v

    # -- searcher API --------------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        import numpy as np

        if self.remaining <= 0:
            return None
        self.remaining -= 1
        keys = list(self.space)
        if len(self._obs) < self.n_initial:
            u = self.np_rng.rand(len(keys))
        else:
            u = self._ei_suggest(keys)
        cats = {k: self._weighted_cat(k, dom)
                for k, dom in self._cats.items()}
        self._pending[trial_id] = (u.copy(), dict(cats))
        out = {k: self._from_unit(self.space[k], u[i])
               for i, k in enumerate(keys)}
        out.update(cats)
        for k, v in self._passthrough.items():
            out[k] = v.sample(self.rng) if isinstance(v, Domain) else v
        return out

    def _weighted_cat(self, k: str, dom: Categorical):
        import numpy as np

        counts = {c: 1.0 for c in dom.categories}
        obs = sorted(self._obs, key=lambda o: o[2], reverse=True)
        for _, cats, _ in obs[:max(2, len(obs) // 4)]:
            if cats.get(k) in counts:
                counts[cats[k]] += 1.0
        cs, w = zip(*counts.items())
        w = np.asarray(w) / sum(w)
        return cs[self.np_rng.choice(len(cs), p=w)]

    def _ei_suggest(self, keys):
        """Maximize Expected Improvement of the GP posterior over random
        candidate points (plus jittered copies of the incumbent)."""
        import numpy as np

        X = np.stack([o[0] for o in self._obs])            # [n, d]
        y = np.asarray([o[2] for o in self._obs])          # [n]
        y_mean, y_std = y.mean(), max(y.std(), 1e-8)
        yn = (y - y_mean) / y_std

        def k_rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale ** 2)

        K = k_rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        n_rand = self.n_candidates
        cand = self.np_rng.rand(n_rand, len(keys))
        best = X[int(np.argmax(yn))]
        jitter = best[None, :] + 0.05 * self.np_rng.randn(16, len(keys))
        cand = np.vstack([cand, np.clip(jitter, 0, 1)])

        Ks = k_rbf(cand, X)                                # [m, n]
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)                       # [n, m]
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        sigma = np.sqrt(var)
        f_best = yn.max()
        z = (mu - f_best - self.xi) / sigma
        # standard-normal pdf/cdf without scipy
        pdf = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / np.sqrt(2)))
        ei = (mu - f_best - self.xi) * cdf + sigma * pdf
        return cand[int(np.argmax(ei))]

    def on_trial_complete(self, trial_id, result=None, error=False):
        pend = self._pending.pop(trial_id, None)
        if pend is None or error or not result or self.metric not in result:
            return
        u, cats = pend
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((u, cats, score))


class SearcherWrapper(Searcher):
    """Adapt any ask/tell optimizer object into a Tune Searcher
    (reference: python/ray/tune/search/ ships nine per-library
    integrations — OptunaSearch, HyperOptSearch, AxSearch, BOHB, HEBO,
    Nevergrad, ZOOpt... — all of which reduce to an ask/tell loop; this
    one duck-typed shim covers that surface without bundling any of
    the libraries).

    The wrapped object needs:
      * ``ask()`` returning either a config dict, or a trial-like
        object whose config is found under ``.params`` / ``.config``
        / ``.args`` (optuna's ``study.ask()`` returns a Trial with
        ``.params``... populated on access; for such lazy objects pass
        ``to_config=`` to extract the dict yourself), and
      * ``tell(token, value)`` where ``token`` is exactly what ask()
        returned (skopt/nevergrad style) — the wrapper remembers it
        per trial.

    ``mode="max"`` negates values before tell() for minimizers (every
    ask/tell library minimizes by default; pass ``minimize=False`` if
    yours maximizes).

    The run ends when ``ask()`` returns None — the wrapped optimizer
    owns the trial budget (wrap in ConcurrencyLimiter/your own counter
    for unbounded optimizers).
    """

    def __init__(self, opt, metric: Optional[str] = None,
                 mode: Optional[str] = None, *, to_config=None,
                 minimize: bool = True):
        super().__init__(metric=metric, mode=mode)
        for attr in ("ask", "tell"):
            if not callable(getattr(opt, attr, None)):
                raise TypeError(
                    f"SearcherWrapper needs an object with ask()/tell(); "
                    f"{type(opt).__name__} has no {attr}()")
        self._opt = opt
        self._to_config = to_config
        self._minimize = minimize
        self._tokens: Dict[str, Any] = {}

    def _extract(self, token) -> Dict[str, Any]:
        if self._to_config is not None:
            return dict(self._to_config(token))
        if isinstance(token, dict):
            return dict(token)
        for attr in ("params", "config", "args"):
            cfg = getattr(token, attr, None)
            if isinstance(cfg, dict):
                return dict(cfg)
        raise TypeError(
            f"cannot extract a config dict from {type(token).__name__}; "
            "pass to_config= to SearcherWrapper")

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        token = self._opt.ask()
        if token is None:
            return None            # optimizer exhausted
        self._tokens[trial_id] = token
        return self._extract(token)

    def on_trial_complete(self, trial_id, result=None, error=False):
        token = self._tokens.pop(trial_id, None)
        if token is None:
            return
        if error or not result or self.metric not in result:
            # most ask/tell libraries accept a failure signal as a very
            # bad value; losing one observation is safer than feeding a
            # fake number — skip the tell
            return
        value = float(result[self.metric])
        mode = self.mode or "max"
        if self._minimize and mode == "max":
            value = -value
        elif not self._minimize and mode == "min":
            value = -value
        self._opt.tell(token, value)
