"""Trial schedulers: early stopping and population-based training.

Mirrors the reference (reference: python/ray/tune/schedulers/ —
trial_scheduler.py TrialScheduler, async_hyperband.py ASHA,
median_stopping_rule.py, pbt.py PopulationBasedTraining): the controller
feeds every reported result to the scheduler, which answers
CONTINUE / PAUSE / STOP; PBT additionally mutates paused trials' configs
and restarts them from a donor's checkpoint (exploit + explore).
"""

from __future__ import annotations

import logging
import math
import random
from typing import Any, Callable, Dict, List, Optional

from .trial import Trial

logger = logging.getLogger(__name__)

CONTINUE = "CONTINUE"
PAUSE = "PAUSE"
STOP = "STOP"


class TrialScheduler:
    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict[str, Any]) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_add(self, trial: Trial):
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial):
        pass

    def on_trial_error(self, trial: Trial):
        pass

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        """Default: any PENDING trial (FIFO)."""
        from .trial import PENDING

        for t in trials:
            if t.status == PENDING:
                return t
        return None

    def trials_to_stop(self):
        """Trial ids the scheduler decided to cull outside their own
        report (drained by the controller each step)."""
        return ()


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped
    unless it is in the top 1/reduction_factor of results recorded there."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: float = 3,
                 max_t: int = 100):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung levels: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: List[int] = []
        r = grace_period
        while r < max_t:
            self.rungs.append(int(r))
            r *= reduction_factor
        self.rung_results: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._recorded: Dict[str, set] = {}  # trial_id -> rungs recorded

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        score = self._score(result)
        decision = CONTINUE
        seen = self._recorded.setdefault(trial.trial_id, set())
        for rung in reversed(self.rungs):
            if t < rung or rung in seen:
                continue
            # each trial contributes to a rung exactly once
            seen.add(rung)
            recorded = self.rung_results[rung]
            recorded.append(score)
            if len(recorded) >= self.rf:
                cutoff_idx = max(0, int(len(recorded) / self.rf) - 1)
                cutoff = sorted(recorded, reverse=True)[cutoff_idx]
                if score < cutoff:
                    decision = STOP
            break  # only the highest new rung reached this round
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages at the same step (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._trial_scores: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        self._trial_scores.setdefault(trial.trial_id, []).append(score)
        if t < self.grace_period:
            return CONTINUE
        others = [sum(v) / len(v) for k, v in self._trial_scores.items()
                  if k != trial.trial_id and v]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        best = max(self._trial_scores[trial.trial_id])
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): every
    perturbation_interval, bottom-quantile trials PAUSE; the controller
    clones the config of a top-quantile donor, perturbs it via
    hyperparam_mutations, and restarts the trial from the donor's
    checkpoint."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        # controller reads + clears this: trial_id -> (new_config, donor)
        self.pending_exploits: Dict[str, tuple] = {}

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        for k, domain in self.mutations.items():
            if isinstance(domain, list):
                if self.rng.random() < self.resample_p or k not in new:
                    new[k] = self.rng.choice(domain)
                else:
                    i = domain.index(new[k]) if new[k] in domain else 0
                    j = min(max(i + self.rng.choice([-1, 1]), 0),
                            len(domain) - 1)
                    new[k] = domain[j]
            elif callable(domain):
                if self.rng.random() < self.resample_p or k not in new:
                    new[k] = domain()
                else:
                    new[k] = new[k] * self.rng.choice([0.8, 1.2])
            else:
                from .search import Domain

                if isinstance(domain, Domain):
                    if self.rng.random() < self.resample_p or k not in new:
                        new[k] = domain.sample(self.rng)
                    else:
                        new[k] = new[k] * self.rng.choice([0.8, 1.2])
        return new

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        # rank current population by last seen score
        peers = [(tid, scores[-1])
                 for tid, scores in self._population().items() if scores]
        self._record(trial.trial_id, self._score(result))
        peers = [(tid, s) for tid, s in peers if tid != trial.trial_id]
        peers.append((trial.trial_id, self._score(result)))
        if len(peers) < 2:
            return CONTINUE
        peers.sort(key=lambda p: p[1], reverse=True)
        n = len(peers)
        k = max(1, int(math.ceil(n * self.quantile)))
        top = [tid for tid, _ in peers[:k]]
        bottom = [tid for tid, _ in peers[-k:]]
        if trial.trial_id in bottom and trial.trial_id not in top:
            donor_id = self.rng.choice(top)
            self.pending_exploits[trial.trial_id] = (donor_id,)
            return PAUSE
        return CONTINUE

    _scores: Dict[str, List[float]] = None

    def _population(self) -> Dict[str, List[float]]:
        if self._scores is None:
            self._scores = {}
        return self._scores

    def _record(self, tid: str, score: float):
        self._population().setdefault(tid, []).append(score)

    def make_exploit_config(self, donor: Trial) -> Dict[str, Any]:
        return self._explore(donor.config)


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: tune/schedulers/hyperband.py).

    Trials are assigned round-robin to brackets; each bracket runs
    successive halving: at every rung milestone the cohort synchronizes
    (arrivals wait as PENDING but are not chosen to run), then the top
    1/eta advance and the rest are culled via `trials_to_stop`, which the
    controller drains.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, eta: int = 3):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = eta
        # bracket s: initial budget r0 = max_t / eta^s
        s_max = int(math.floor(math.log(max_t, eta)))
        self.brackets: List[Dict[str, Any]] = []
        for s in range(s_max, -1, -1):
            r0 = max(1, int(max_t / (eta ** s)))
            rungs = []
            r = r0
            while r <= max_t:
                rungs.append(r)
                r *= eta
            self.brackets.append({"s": s, "rungs": rungs,
                                  "trials": [],      # trial ids in bracket
                                  # rung idx -> {trial_id: score}
                                  "scores": {},
                                  # trial_id -> next allowed rung idx
                                  "at_rung": {}})
        self._bracket_of: Dict[str, int] = {}
        self._next_bracket = 0
        self._stop: set = set()
        self._done: set = set()

    def on_trial_add(self, trial: Trial):
        if trial.trial_id in self._bracket_of:
            return
        b = self._next_bracket % len(self.brackets)
        self._next_bracket += 1
        self._bracket_of[trial.trial_id] = b
        br = self.brackets[b]
        br["trials"].append(trial.trial_id)
        br["at_rung"][trial.trial_id] = 0

    def _ensure_added(self, trial: Trial):
        """Restored experiments bypass on_trial_add (resumed trials are
        handed straight to the controller) — register lazily."""
        if trial.trial_id not in self._bracket_of:
            self.on_trial_add(trial)

    def trials_to_stop(self):
        out, self._stop = self._stop, set()
        return out

    def _live_cohort(self, br, rung_idx) -> List[str]:
        """Trials expected to report at this rung (not culled/errored)."""
        return [tid for tid in br["trials"]
                if br["at_rung"].get(tid, -1) == rung_idx
                and tid not in self._done]

    def _maybe_promote(self, br, rung_idx):
        """If the rung's live cohort has fully reported, promote the top
        1/eta and cull the rest.  Called on every report AND whenever a
        cohort member leaves (complete/error) — otherwise the waiters
        strand as PENDING forever."""
        reported = br["scores"].get(rung_idx, {})
        cohort = self._live_cohort(br, rung_idx)
        waiting = [tid for tid in cohort if tid not in reported]
        if waiting or not reported:
            return
        ranked = sorted(reported.items(), key=lambda kv: kv[1], reverse=True)
        keep = max(1, len(ranked) // self.eta)
        if rung_idx + 1 >= len(br["rungs"]):
            keep = 0  # last rung: everyone stops
        for i, (mid, _) in enumerate(ranked):
            if mid in self._done:
                continue
            if i < keep:
                br["at_rung"][mid] = rung_idx + 1
            else:
                self._done.add(mid)
                self._stop.add(mid)

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        self._ensure_added(trial)
        tid = trial.trial_id
        br = self.brackets[self._bracket_of[tid]]
        rung_idx = br["at_rung"].get(tid, 0)
        if rung_idx >= len(br["rungs"]):
            return STOP  # finished the last rung
        t = result.get(self.time_attr, 0)
        if t < br["rungs"][rung_idx]:
            return CONTINUE
        # reached the milestone: record + synchronize
        br["scores"].setdefault(rung_idx, {})[tid] = self._score(result)
        self._maybe_promote(br, rung_idx)
        if tid in self._done:
            self._stop.discard(tid)  # we answer this one directly
            return STOP
        if br["at_rung"].get(tid, 0) > rung_idx:
            return CONTINUE  # promoted immediately (cohort was complete)
        return PAUSE  # wait for the cohort (stays PENDING, not chosen)

    def _on_trial_left(self, trial: Trial):
        """Completion or error removes the trial from its cohorts; the
        rungs it was gating may now be promotable."""
        tid = trial.trial_id
        self._done.add(tid)
        b = self._bracket_of.get(tid)
        if b is None:
            return
        br = self.brackets[b]
        for rung_idx in range(len(br["rungs"])):
            self._maybe_promote(br, rung_idx)

    def on_trial_error(self, trial: Trial):
        self._on_trial_left(trial)

    def on_trial_complete(self, trial: Trial):
        self._on_trial_left(trial)

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        from .trial import PENDING

        for t in trials:
            if t.status != PENDING:
                continue
            self._ensure_added(t)
            tid = t.trial_id
            if tid in self._done or tid in self._stop:
                continue
            br = self.brackets[self._bracket_of[tid]]
            rung_idx = br["at_rung"].get(tid, 0)
            if rung_idx >= len(br["rungs"]):
                continue
            # runnable iff its rung is not waiting on a full lower cohort
            if br["scores"].get(rung_idx, {}).get(tid) is None:
                return t
        return None


class PB2(PopulationBasedTraining):
    """PBT with a GP-UCB exploration step (reference:
    tune/schedulers/pb2.py) — instead of random perturbation, fit a
    Gaussian process mapping hyperparameters -> score improvement and pick
    the UCB-maximizing candidate inside `hyperparam_bounds`.  Numpy-only
    (the reference depends on GPy; same math, RBF kernel)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, tuple]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode, time_attr, perturbation_interval,
                         hyperparam_mutations={}, 
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = hyperparam_bounds or {}
        #: (hyperparam vector, score delta) observations
        self._gp_data: List[tuple] = []
        self._last_score: Dict[str, float] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last >= self.interval and self.bounds:
            score = self._score(result)
            prev = self._last_score.get(trial.trial_id)
            if prev is not None:
                x = [float(trial.config.get(k, (lo + hi) / 2))
                     for k, (lo, hi) in sorted(self.bounds.items())]
                self._gp_data.append((x, score - prev))
            self._last_score[trial.trial_id] = score
        return super().on_trial_result(trial, result)

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        new = dict(config)
        if not self.bounds:
            return new
        keys = sorted(self.bounds.keys())
        lo = np.asarray([self.bounds[k][0] for k in keys], float)
        hi = np.asarray([self.bounds[k][1] for k in keys], float)
        if len(self._gp_data) < 4:
            for k, l, h in zip(keys, lo, hi):
                new[k] = float(self.rng.uniform(l, h))
            return new
        X = np.asarray([x for x, _ in self._gp_data], float)
        y = np.asarray([d for _, d in self._gp_data], float)
        y = (y - y.mean()) / (y.std() + 1e-8)
        # normalize inputs to [0,1]
        Xn = (X - lo) / np.maximum(hi - lo, 1e-12)
        ls, sn = 0.3, 1e-3

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (ls * ls))

        K = k(Xn, Xn) + sn * np.eye(len(Xn))
        Kinv_y = np.linalg.solve(K, y)
        cand = np.random.RandomState(
            self.rng.randrange(1 << 31)).rand(64, len(keys))
        Kc = k(cand, Xn)
        mu = Kc @ Kinv_y
        var = 1.0 - np.einsum("ij,jk,ik->i", Kc, np.linalg.inv(K), Kc)
        ucb = mu + 1.0 * np.sqrt(np.maximum(var, 1e-12))
        best = cand[int(np.argmax(ucb))]
        for k_, v in zip(keys, lo + best * (hi - lo)):
            new[k_] = float(v)
        return new
