"""Tree-structured Parzen Estimator (TPE) over a typed search space.

Port of ``cross_patient_speech_decoding_tpu/sweep/bayes.py:36-195``: the
search-space specs (``Float``, ``Categorical``), ``default_ctc_space``,
``sample_random`` and ``TPESampler``, numpy on the host, copied so that
the same seed proposes the same configs bit for bit. The reference tunes
its classical pipeline with ``BayesSearchCV(n_iter=25, n_points=5)``;
the nested search of ``decoders/nested_cv.py`` proposes each round's
candidates with this sampler and scores them in batched device programs.

Continuous parameters get good/bad kernel-density mixtures in (optionally
log-) transformed unit space with a uniform floor; categoricals get
smoothed count ratios. Proposals are the top-n of one draw from the good
density by l(x)/g(x).

``run_bohb`` (``:197-303``) chains TPE proposals through the
successive-halving rungs of ``sweep/search.py`` and its resumable
manifest; ``cpsd tune-ctc sampler=tpe`` runs it over the CTC bucket
trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

from cross_patient_speech_decoding_tpu_torch.sweep.search import Manifest


@dataclass(frozen=True)
class Float:
    lo: float
    hi: float
    log: bool = False

    def to_unit(self, x):
        lo, hi = (np.log(self.lo), np.log(self.hi)) if self.log else (self.lo, self.hi)
        v = np.log(x) if self.log else np.asarray(x, float)
        return (v - lo) / (hi - lo)

    def from_unit(self, u):
        lo, hi = (np.log(self.lo), np.log(self.hi)) if self.log else (self.lo, self.hi)
        v = lo + np.clip(u, 0.0, 1.0) * (hi - lo)
        return np.exp(v) if self.log else v


@dataclass(frozen=True)
class Categorical:
    choices: tuple

    def index(self, x):
        return self.choices.index(x)


SearchSpace = Mapping[str, Float | Categorical]


def default_ctc_space() -> dict:
    """The reference CTC search space as specs: arch choices from the
    random-search space (tune_ctc_rnn.py:212-222), continuous ranges from
    the BOHB ConfigurationSpace (:224-232, lr log-uniform 1e-5..1e-2,
    l2_reg log-uniform 1e-6..1e-3). ``batch_size``/``gclip_val`` are
    deliberately fixed trainer settings (see sweep.search.SweepSpace)."""
    return {
        "lr": Float(1e-5, 1e-2, log=True),
        "weight_decay": Float(1e-6, 1e-3, log=True),
        "hidden": Categorical((128, 256, 512)),
        "n_layers": Categorical((2, 3, 4, 5)),
        "dropout": Categorical((0.2, 0.3, 0.4)),
    }


def sample_random(space: SearchSpace, n: int, rng: np.random.Generator):
    out = []
    for _ in range(n):
        cfg = {}
        for name, spec in space.items():
            if isinstance(spec, Float):
                cfg[name] = float(spec.from_unit(rng.uniform()))
            else:
                choice = spec.choices[rng.integers(len(spec.choices))]
                cfg[name] = choice
        out.append(cfg)
    return out


class TPESampler:
    """Tree-structured Parzen Estimator over a typed search space.

    ``fit`` on (config, metric) history (lower metric = better), then
    ``propose`` new configs maximizing the good/bad density ratio.
    """

    def __init__(self, space: SearchSpace, *, gamma: float = 0.25,
                 n_ei_candidates: int = 64, seed: int = 0):
        self.space = dict(space)
        self.gamma = gamma
        self.n_ei = n_ei_candidates
        self.rng = np.random.default_rng(seed)
        self._good: list[dict] | None = None
        self._bad: list[dict] | None = None

    # -- density model ----------------------------------------------------

    def fit(self, history: Sequence[tuple[dict, float]]):
        hist = sorted(history, key=lambda cm: cm[1])
        n = len(hist)
        # hyperopt-style selective good set: ~gamma * sqrt(n)
        n_good = max(2, int(np.ceil(self.gamma * np.sqrt(n))))
        self._good = [c for c, _ in hist[:n_good]]
        self._bad = [c for c, _ in hist[n_good:]] or [c for c, _ in hist]
        return self

    def _kde_logpdf(self, spec: Float, obs: np.ndarray, x: np.ndarray):
        """Gaussian mixture at unit-space observations + uniform floor."""
        if obs.size == 0:
            return np.zeros_like(x)
        bw = self._bandwidth(obs)
        d = (x[:, None] - obs[None, :]) / bw
        comp = np.exp(-0.5 * d * d) / (bw * np.sqrt(2 * np.pi))
        # small uniform component (p=1 on [0,1]) keeps densities proper
        # outside the observed support without washing out the model
        w_unif = 0.2
        pdf = (1 - w_unif) * comp.mean(1) + w_unif
        return np.log(pdf)

    @staticmethod
    def _bandwidth(obs: np.ndarray) -> float:
        return float(
            np.clip(1.06 * (obs.std() + 1e-3) * obs.size ** (-0.2), 0.08, 0.5)
        )

    def _cat_probs(self, spec: Categorical, configs: list[dict], name: str,
                   smooth: float = 0.5):
        counts = np.full(len(spec.choices), smooth)
        for c in configs:
            counts[spec.index(c[name])] += 1.0
        return counts / counts.sum()

    # -- proposal ----------------------------------------------------------

    def _draw_from_good(self, n: int) -> list[dict]:
        cfgs = []
        for _ in range(n):
            cfg = {}
            for name, spec in self.space.items():
                if isinstance(spec, Float):
                    obs = np.array([spec.to_unit(c[name]) for c in self._good])
                    if obs.size and self.rng.uniform() > 0.1:
                        center = obs[self.rng.integers(obs.size)]
                        bw = self._bandwidth(obs)
                        u = np.clip(self.rng.normal(center, bw), 0.0, 1.0)
                    else:
                        u = self.rng.uniform()
                    cfg[name] = float(spec.from_unit(u))
                else:
                    p = self._cat_probs(spec, self._good, name)
                    cfg[name] = spec.choices[self.rng.choice(len(p), p=p)]
            cfgs.append(cfg)
        return cfgs

    def _score(self, cfgs: list[dict]) -> np.ndarray:
        """log l(x) - log g(x) for each candidate."""
        score = np.zeros(len(cfgs))
        for name, spec in self.space.items():
            if isinstance(spec, Float):
                x = np.array([spec.to_unit(c[name]) for c in cfgs])
                good = np.array([spec.to_unit(c[name]) for c in self._good])
                bad = np.array([spec.to_unit(c[name]) for c in self._bad])
                score += self._kde_logpdf(spec, good, x)
                score -= self._kde_logpdf(spec, bad, x)
            else:
                pg = self._cat_probs(spec, self._good, name)
                pb = self._cat_probs(spec, self._bad, name)
                idx = np.array([spec.index(c[name]) for c in cfgs])
                score += np.log(pg[idx]) - np.log(pb[idx])
        return score

    def propose(self, n: int = 1) -> list[dict]:
        """n configs: the top-n of one ``n_ei_candidates`` draw by l/g.

        Taking the top-n of a single pool (instead of n argmaxes) keeps a
        proposed batch diverse — n independent argmaxes of the same
        density ratio are near-duplicates and waste evaluations.
        """
        assert self._good is not None, "call fit(history) first"
        cands = self._draw_from_good(max(self.n_ei, 4 * n))
        order = np.argsort(-self._score(cands))
        return [cands[i] for i in order[:n]]


def run_bohb(
    space: SearchSpace,
    train_bucket: Callable,
    *,
    n_trials: int = 24,
    batch: int = 6,
    rungs: tuple = (1,),
    eta: int = 3,
    n_random_init: int | None = None,
    manifest: Manifest | None = None,
    seed: int = 0,
) -> list[dict]:
    """BOHB-style search: TPE proposals fed through successive halving.

    Brackets of ``batch`` configs are proposed (random until
    ``n_random_init`` observations, then TPE) and run through the rung
    schedule with the architecture-bucketed device trainer: every config
    trains at ``rungs[0]`` epochs, the best 1/eta continue to the next
    rung, etc. *Every* evaluation — including rung dropouts — enters the
    observation pool; the TPE model fits on the largest budget that has
    enough points (the BOHB rule), so cheap-rung evidence guides search
    without polluting cross-budget rankings. Lower metric is better.

    ``n_trials`` counts proposed configs. Returns {"config", "metric",
    "epochs"} records; sorted best-first *within* the highest completed
    budget first (a low-rung noisy metric never outranks a full-budget
    result).
    """
    rng = np.random.default_rng(seed)
    n_random_init = batch if n_random_init is None else n_random_init
    sampler = TPESampler(space, seed=seed + 1)
    manifest = manifest or Manifest(None)
    # observations per budget: epochs -> list[(config, metric)]
    obs: dict[int, list[tuple[dict, float]]] = {}
    for rec in manifest.done.values():
        obs.setdefault(int(rec.get("epochs", rungs[-1])), []).append(
            (rec["config"], rec["metric"])
        )
    n_proposed = sum(len(v) for v in obs.values())
    min_fit = len(space) + 2

    while n_proposed < n_trials:
        k = min(batch, n_trials - n_proposed)
        fit_pool = [
            pool for e, pool in sorted(obs.items(), reverse=True)
            if len(pool) >= min_fit
        ]
        if n_proposed < n_random_init or not fit_pool:
            cfgs = sample_random(space, k, rng)
        else:
            cfgs = sampler.fit(fit_pool[0]).propose(k)
        n_proposed += len(cfgs)

        # resume/dedupe: configs already completed in the manifest keep
        # their recorded result (already in ``obs`` — loaded at startup or
        # appended when their bracket finished) instead of retraining
        live = [c for c in cfgs if manifest.completed(c) is None]
        import time as _time

        for i, epochs in enumerate(rungs):
            if not live:
                break
            scored = []
            for _, bucket_cfgs in _bucket_items(live):
                t0 = _time.monotonic()
                metrics = train_bucket(bucket_cfgs, int(epochs))
                wall = (_time.monotonic() - t0) / max(1, len(bucket_cfgs))
                scored.extend(
                    (c, m, wall) for c, m in zip(bucket_cfgs, metrics)
                )
            scored.sort(key=lambda cm: cm[1])
            obs.setdefault(int(epochs), []).extend(
                (c, float(m)) for c, m, _ in scored
            )
            if i == len(rungs) - 1:
                for c, m, wall in scored:
                    manifest.record(c, float(m), {
                        "epochs": int(epochs), "wall_s": round(wall, 2),
                        "done_at": round(_time.time(), 1)})
                live = []
            else:
                keep = max(1, len(scored) // eta)
                live = [c for c, _, _ in scored[:keep]]
                # rung dropouts persist too: their cheap-rung evaluations
                # must survive a restart (they re-enter ``obs`` at their
                # own budget) and must not retrain if TPE re-proposes them
                for c, m, wall in scored[keep:]:
                    manifest.record(
                        c, float(m),
                        {"epochs": int(epochs), "eliminated_at_rung": i,
                         "wall_s": round(wall, 2),
                         "done_at": round(_time.time(), 1)},
                    )

    results = []
    for epochs in sorted(obs, reverse=True):
        results.extend(
            {"config": c, "metric": m, "epochs": epochs}
            for c, m in sorted(obs[epochs], key=lambda cm: cm[1])
        )
    return results


def _bucket_items(trials):
    from cross_patient_speech_decoding_tpu_torch.sweep.search import _bucket

    return _bucket(trials).items()
