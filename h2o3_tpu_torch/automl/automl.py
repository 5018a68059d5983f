"""H2OAutoML — automatic model selection under a budget.

A copy of `h2o3_tpu/automl/automl.py`, rewired to the port. Reference
parity: `h2o-automl/src/main/java/ai/h2o/automl/AutoML.java`,
`ModelingStepsExecutor.java`, `modeling/*Steps.java` (the step sequence:
XGBoost defaults ×3, GLM, DRF + XRT, GBM ×5, DeepLearning ×3, random grids,
then two StackedEnsembles — BestOfFamily and AllModels), `Leaderboard.java`
(rank by CV metric), `events/EventLog.java`. Client surface
`h2o-py/h2o/automl/_estimator.py` (`H2OAutoML(max_models=, max_runtime_secs=)
.train()`, `.leaderboard`, `.leader`).

Budgeting: `max_models` counts base models (as upstream); `max_runtime_secs`
is checked between steps. Every base model trains with nfolds=5 CV so the
ensembles can stack holdout predictions. The candidates train through the
train pool (`runtime/trainpool.py`) on the card unless `device="cpu"` asks
for the CPU; a candidate that fails is recorded as failed in the event
log, as in the reference, and nothing moves to the CPU.

One step differs from a straight copy: on a multinomial problem the
reference's GLM_1 asks for `lambda_search=True`, which its multinomial
fit never reads (it fits λ = 0). The port's GLM raises for that request
(ROADMAP §C), so the port's GLM_1 asks for the model the reference
computes, α 0.5 at λ = 0. The reference accepts `balance_classes` and
never reads it (no candidate gets it); the port raises for
`balance_classes=True`.

Not ported: AutoML over a frame on an attached server (`_remote_train`)
needs the REST client, ROADMAP queue A, item 11; the in-flight pointer of
a checkpointed run needs the supervisor's fit-level checkpoints (items 5
and 9).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..frame.frame import Frame
from ..models.model_base import check_unread, response_info


class EventLog:
    """ai.h2o.automl.events.EventLog — timestamped progress records."""

    def __init__(self):
        self.events: List[Dict] = []

    def log(self, stage: str, message: str):
        self.events.append({"timestamp": time.time(), "stage": stage, "message": message})


class Leaderboard:
    """ai.h2o.automl.Leaderboard — models ranked by CV metric."""

    def __init__(self, sort_metric: str, decreasing: bool):
        self.sort_metric = sort_metric
        self.decreasing = decreasing
        self.rows: List[Dict] = []

    def add(self, est, lb_frame=None):
        m = (est.model.model_performance(lb_frame) if lb_frame is not None
             else est.model._m(xval=True))
        row = {
            "model_id": est.model_id,
            "algo": est.algo,
            "_est": est,
        }
        for name in ("auc", "logloss", "mean_per_class_error", "rmse", "mse", "mae"):
            row[name] = getattr(m, name, float("nan"))
        self.rows.append(row)
        self._sort()

    def _sort(self):
        key = self.sort_metric

        def sk(r):
            v = r.get(key, float("nan"))
            bad = v is None or (isinstance(v, float) and np.isnan(v))
            return (bad, -v if (self.decreasing and not bad) else (v if not bad else 0))

        self.rows.sort(key=sk)

    def as_data_frame(self, use_pandas=False):
        return [
            {k: v for k, v in r.items() if not k.startswith("_")} for r in self.rows
        ]

    def as_frame(self):
        """Leaderboard as a Frame (the h2o-py leaderboard frame surface)."""
        rows = self.as_data_frame()
        if not rows:
            return Frame({})
        cols = {}
        for k in rows[0]:
            vals = [r.get(k) for r in rows]
            if isinstance(vals[0], str):
                cols[k] = np.asarray(vals, dtype=object)
            else:
                cols[k] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
        return Frame.from_dict(cols, column_types={"model_id": "enum",
                                                   "algo": "enum"})

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


class H2OAutoML:
    def __init__(
        self,
        max_models: Optional[int] = None,
        max_runtime_secs: float = 3600.0,
        max_runtime_secs_per_model: float = 0.0,
        seed: Optional[int] = None,
        nfolds: int = 5,
        sort_metric: str = "AUTO",
        stopping_metric: str = "AUTO",
        stopping_rounds: int = 3,
        stopping_tolerance: float = -1.0,
        exclude_algos: Optional[List[str]] = None,
        include_algos: Optional[List[str]] = None,
        balance_classes: bool = False,
        project_name: Optional[str] = None,
        verbosity: Optional[str] = None,
        keep_cross_validation_predictions: bool = True,
        parallelism: int = 1,
        checkpoint_dir: Optional[str] = None,
        device: Optional[str] = None,
        **kw,
    ):
        check_unread("AutoML", None, dict(balance_classes=balance_classes),
                     dict(balance_classes=False))
        self.max_models = max_models
        self._lb_frame = None
        self.max_runtime_secs = max_runtime_secs
        self.max_runtime_secs_per_model = max_runtime_secs_per_model
        self.seed = seed if seed is not None else 1234
        self.nfolds = max(int(nfolds), 2)
        self.sort_metric = sort_metric
        self.exclude_algos = set(a.upper() for a in (exclude_algos or []))
        self.include_algos = (
            set(a.upper() for a in include_algos) if include_algos else None
        )
        self.project_name = project_name or f"automl_{int(time.time())}"
        # candidate builds in flight at once (runtime/trainpool.py); results
        # enter the leaderboard in submission order, so any parallelism
        # produces the same leaderboard as the sequential walk
        self.parallelism = max(int(parallelism or 1), 1)
        # sweep checkpoint/resume (runtime/trainpool.SweepCheckpoint): with
        # a checkpoint_dir, every completed candidate persists a record +
        # model artifact, and a killed run re-submitted under the SAME
        # project_name restores those candidates instead of retraining them
        # (candidate names are deterministic given seed/include lists)
        self.checkpoint_dir = checkpoint_dir
        self._ckpt = None
        # the port's own: where every candidate and ensemble trains ("cuda",
        # the default, or "cpu")
        self.device = device
        self.event_log = EventLog()
        self.leaderboard: Optional[Leaderboard] = None
        self.leader = None
        self._models: List = []

    def _allowed(self, algo: str) -> bool:
        algo = algo.upper()
        if self.include_algos is not None:
            return algo in self.include_algos
        return algo not in self.exclude_algos

    # the fixed modeling plan of ai.h2o.automl.modeling.*Steps
    def _steps(self, problem: str) -> List[Dict[str, Any]]:
        from ..models.deeplearning import H2ODeepLearningEstimator
        from ..models.drf import H2ORandomForestEstimator
        from ..models.gbm import H2OGradientBoostingEstimator
        from ..models.glm import H2OGeneralizedLinearEstimator
        from ..models.xgboost import H2OXGBoostEstimator

        steps = []

        def add(algo, cls, name, **parms):
            if self._allowed(algo):
                steps.append({"algo": algo, "cls": cls, "name": name, "parms": parms})

        # XGBoost defaults ×3 (XGBoostSteps def_1..3)
        add("XGBOOST", H2OXGBoostEstimator, "XGBoost_1",
            ntrees=50, max_depth=6, learn_rate=0.3, sample_rate=0.8,
            col_sample_rate_per_tree=0.8, reg_lambda=1.0)
        add("XGBOOST", H2OXGBoostEstimator, "XGBoost_2",
            ntrees=50, max_depth=10, learn_rate=0.2, sample_rate=0.6,
            col_sample_rate_per_tree=0.8, reg_lambda=1.0, min_rows=5.0)
        add("XGBOOST", H2OXGBoostEstimator, "XGBoost_3",
            ntrees=50, max_depth=3, learn_rate=0.3, sample_rate=0.8,
            col_sample_rate_per_tree=0.8, reg_lambda=1.0)
        # GLM (GLMSteps def_1: lambda search). The reference's multinomial
        # fit never reads lambda_search and fits λ = 0 (its glm.py
        # `_fit_multinomial` branch); the port's GLM raises for the request
        # (ROADMAP §C), so a multinomial GLM_1 asks for that model itself
        if problem == "multinomial":
            add("GLM", H2OGeneralizedLinearEstimator, "GLM_1",
                alpha=0.5, lambda_=0.0)
        else:
            add("GLM", H2OGeneralizedLinearEstimator, "GLM_1",
                lambda_search=True, alpha=0.5)
        # DRF + XRT (DRFSteps)
        add("DRF", H2ORandomForestEstimator, "DRF_1", ntrees=50)
        add("DRF", H2ORandomForestEstimator, "XRT_1", ntrees=50,
            histogram_type="Random")
        # GBM ×5 (GBMSteps def_1..5)
        for i, (d, r) in enumerate([(6, 0.8), (7, 0.8), (8, 0.8), (10, 0.6), (15, 0.6)], 1):
            add("GBM", H2OGradientBoostingEstimator, f"GBM_{i}",
                ntrees=60, max_depth=d, sample_rate=r, learn_rate=0.1,
                col_sample_rate=0.8)
        # DeepLearning ×3 (DeepLearningSteps)
        add("DEEPLEARNING", H2ODeepLearningEstimator, "DeepLearning_1",
            hidden=[64, 64], epochs=10, mini_batch_size=128)
        add("DEEPLEARNING", H2ODeepLearningEstimator, "DeepLearning_2",
            hidden=[128], epochs=10, mini_batch_size=128)
        add("DEEPLEARNING", H2ODeepLearningEstimator, "DeepLearning_3",
            hidden=[32, 32, 32], epochs=10, mini_batch_size=128)
        return steps

    def _candidate(self, name, cls, parms, x, y, training_frame):
        """(name, build_fn) for the train pool — one leaderboard model."""
        parms = dict(parms)
        parms["seed"] = self.seed
        parms["nfolds"] = self.nfolds
        parms["keep_cross_validation_predictions"] = True
        # reference AutoML default: fold models are discarded once their
        # holdout predictions/metrics are extracted (frees the device-
        # resident fold forests — deep DRF folds are ~600 MB HBM each)
        parms["keep_cross_validation_models"] = False
        if self.max_runtime_secs_per_model:
            parms["max_runtime_secs"] = self.max_runtime_secs_per_model
        if self.device is not None:
            parms["device"] = self.device

        def fn(job):
            est = cls(**parms)
            est._external_job = job   # pool cancel reaches the fit loop
            # the reference marks the candidate in flight here when its
            # supervisor keeps fit-level checkpoints; the port has no
            # supervisor (ROADMAP queue A, items 5 and 9), so a killed run
            # retrains an unfinished candidate from the start
            est.train(x=x, y=y, training_frame=training_frame)
            est._automl_name = name
            return est

        return (name, fn)

    def _checkpoint_candidate(self, name: str, est) -> None:
        """Persist one completed candidate's record (+ artifact when the
        mojo format covers the algo) so a killed run resumes past it.
        Metrics come straight from the leaderboard row Leaderboard.add
        just computed for this model (leaderboard_frame when given, else
        CV) — same footing as fresh rows, and no second scoring pass over
        the leaderboard frame."""
        row = next((r for r in self.leaderboard.rows
                    if r.get("model_id") == est.model_id), {})
        metrics = {}
        for k in self._LEADERBOARD_METRICS:
            v = row.get(k)
            if isinstance(v, (int, float)):
                metrics[k] = float(v)
        payload = dict(model_id=est.model_id, algo=est.algo,
                       metrics=metrics)
        try:
            from ..mojo import save_model

            fname = f"{self.project_name}_{name}.h2o3"
            save_model(est, self.checkpoint_dir, filename=fname, force=True)
            payload["file"] = fname
        except (TypeError, OSError):
            pass    # file-less record: the candidate retrains on resume
        self._ckpt.mark(name, payload)

    def _restorable(self, name: str) -> Optional[Dict]:
        """Checkpoint record usable for restore: it exists AND its artifact
        is still on disk. A file-less record (mojo export failed) or a lost
        artifact must retrain the candidate — restoring it would put an
        unscorable shim on the leaderboard that crashes predict() later."""
        import os

        if self._ckpt is None:
            return None
        p = self._ckpt.completed(name)
        if p and p.get("file") and os.path.exists(
                os.path.join(self.checkpoint_dir, p["file"])):
            return p
        return None

    def _restore_candidate(self, name: str, payload: Dict) -> None:
        """Rebuild a leaderboard entry from its checkpoint record: metric
        values replay from the payload, predict() scores through the saved
        artifact (grid._RecoveredModel does exactly this for grids)."""
        import os

        from ..models.grid import _RecoveredModel
        from ..runtime import trainpool as _tp

        metrics = payload.get("metrics") or {}
        path = (os.path.join(self.checkpoint_dir, payload["file"])
                if payload.get("file") else "")
        shim = _RecoveredModel({}, path or f"{name}.h2o3", metrics)
        shim.algo = payload.get("algo", "unknown")
        shim.model_id = payload.get("model_id", name)
        shim._automl_name = name
        row = {"model_id": shim.model_id, "algo": shim.algo, "_est": shim}
        for k in self._LEADERBOARD_METRICS:
            row[k] = metrics.get(k, float("nan"))
        self.leaderboard.rows.append(row)
        self.leaderboard._sort()
        self._models.append(shim)
        _tp.record_resumed()
        self.event_log.log(
            "resume", f"restored {name} ({shim.model_id}) from checkpoint")

    def _run_candidates(self, cands, budget_left) -> bool:
        """Run candidate builds through the train pool (runtime/trainpool)
        in max_models-bounded waves; leaderboard entries land in submission
        order, so parallelism never changes the resulting leaderboard.
        Candidates with a checkpoint record are RESTORED instead of
        retrained (they still count toward max_models). Returns False once
        the budget or max_models is exhausted."""
        from ..runtime import trainpool as _tp

        i = 0
        while i < len(cands):
            if not budget_left():
                self.event_log.log("budget", "max_runtime_secs reached")
                return False
            remaining = (self.max_models - len(self._models)
                         if self.max_models else len(cands) - i)
            if remaining <= 0:
                return False
            name = cands[i][0]
            payload = self._restorable(name)
            if payload is not None:
                i += 1
                self._restore_candidate(name, payload)
                continue
            # fresh batch up to the wave budget, stopping at the next
            # checkpointed candidate so restore order stays deterministic
            batch = []
            while (i < len(cands) and len(batch) < remaining
                   and self._restorable(cands[i][0]) is None):
                batch.append(cands[i])
                i += 1
            pool = _tp.TrainPool(self.parallelism, label=self.project_name)
            recs = pool.run(batch, stop_when=lambda: not budget_left())
            for (name, _), rec in zip(batch, recs):
                if rec.ok:
                    est = rec.result
                    self._models.append(est)
                    self.leaderboard.add(est, self._lb_frame)
                    self.event_log.log(
                        "model", f"built {name} ({est.model_id})")
                    if self._ckpt is not None:
                        self._checkpoint_candidate(name, est)
                elif rec.status == "failed":
                    self.event_log.log("error", f"{name} failed: {rec.error}")
                elif rec.status in ("skipped", "cancelled"):
                    self.event_log.log("budget",
                                       "max_runtime_secs reached")
                    return False
        return True

    def _run_random_grids(self, x, y, training_frame, budget_left):
        import itertools

        from ..models.deeplearning import H2ODeepLearningEstimator
        from ..models.gbm import H2OGradientBoostingEstimator
        from ..models.xgboost import H2OXGBoostEstimator

        rng = np.random.default_rng(self.seed)
        grids = [
            ("GBM", H2OGradientBoostingEstimator, dict(
                max_depth=[3, 5, 7, 9], learn_rate=[0.05, 0.1, 0.2],
                sample_rate=[0.6, 0.8, 1.0], col_sample_rate=[0.4, 0.7, 1.0],
                ntrees=[60])),
            ("XGBOOST", H2OXGBoostEstimator, dict(
                max_depth=[5, 10, 15], learn_rate=[0.05, 0.1, 0.3],
                sample_rate=[0.6, 0.8, 1.0], reg_lambda=[0.1, 1.0, 10.0],
                ntrees=[50])),
            ("DEEPLEARNING", H2ODeepLearningEstimator, dict(
                hidden=[[32], [64, 64], [128, 128]],
                epochs=[10], mini_batch_size=[128])),
        ]
        cands = []
        for gi, (algo, cls, hp) in enumerate(grids):
            if not self._allowed(algo):
                continue
            keys = list(hp)
            combos = [dict(zip(keys, v))
                      for v in itertools.product(*(hp[k] for k in keys))]
            rng.shuffle(combos)
            for ci, parms in enumerate(combos[:3]):  # budget-bounded sample
                cands.append(self._candidate(
                    f"{algo}_grid_1_model_{ci + 1}", cls, parms,
                    x, y, training_frame))
        self._run_candidates(cands, budget_left)

    def _remote_train(self, x, y, training_frame):
        """AutoML against an attached server (POST `/99/AutoMLBuilder` in
        the reference): the port has no REST client yet."""
        raise NotImplementedError(
            "AutoML over a frame on an attached server needs the REST "
            "client (ROADMAP queue A, item 11)")

    def train(self, x=None, y=None, training_frame: Optional[Frame] = None,
              validation_frame=None, leaderboard_frame=None, blending_frame=None,
              **kw):
        assert training_frame is not None and y is not None
        if getattr(training_frame, "_is_remote", False):
            return self._remote_train(x, y, training_frame)
        self._lb_frame = leaderboard_frame
        t0 = time.time()
        if self.checkpoint_dir:
            from ..runtime.trainpool import SweepCheckpoint

            # run identity: candidate names (GBM_1, ...) are constants, so
            # without this a checkpoint from a different dataset/response/
            # seed would silently restore the wrong models. Shape + column
            # names stand in for frame identity (auto-generated frame keys
            # don't survive a process restart).
            fp = dict(
                y=str(y),
                x=sorted(str(c) for c in x) if x is not None else None,
                seed=int(self.seed), nfolds=int(self.nfolds),
                nrow=int(training_frame.nrow), ncol=int(training_frame.ncol),
                columns=[str(c) for c in training_frame.names])
            self._ckpt = SweepCheckpoint(self.checkpoint_dir,
                                         self.project_name, fingerprint=fp)
            if len(self._ckpt):
                self.event_log.log(
                    "resume", f"checkpoint has {len(self._ckpt)} completed "
                    "candidate(s); they will be restored, not retrained")
            stranded = self._ckpt.inflight()
            if stranded:
                # candidates a killed reference run left mid-fit (the port
                # writes no such pointer): they retrain from the start
                self.event_log.log(
                    "resume", f"{len(stranded)} candidate(s) were mid-fit "
                    "when the prior run died "
                    f"({', '.join(sorted(stranded))}); they retrain")
        problem, nclass, domain = response_info(training_frame.vec(y))
        sort_metric = self.sort_metric
        if sort_metric == "AUTO":
            sort_metric = {"binomial": "auc", "multinomial": "mean_per_class_error"}.get(
                problem, "rmse"
            )
        decreasing = sort_metric in ("auc", "pr_auc", "accuracy", "r2")
        self.leaderboard = Leaderboard(sort_metric, decreasing)
        self.event_log.log("init", f"AutoML {self.project_name} problem={problem}")

        budget_left = lambda: (
            self.max_runtime_secs <= 0 or time.time() - t0 < self.max_runtime_secs
        )
        self._run_candidates(
            [self._candidate(s["name"], s["cls"], s["parms"],
                             x, y, training_frame)
             for s in self._steps(problem)],
            budget_left)

        # random grids (modeling.*Steps grids: XGBoost/GBM/DL RandomDiscrete
        # exploration after the defaults, while budget remains)
        self._run_random_grids(x, y, training_frame, budget_left)

        # StackedEnsembles (SE BestOfFamily + AllModels)
        if self._allowed("STACKEDENSEMBLE") and len(self._models) >= 2 and budget_left():
            from ..models.ensemble import H2OStackedEnsembleEstimator
            from ..models.grid import _RecoveredModel

            # checkpoint-restored shims carry no CV holdout predictions to
            # stack — build the ensembles over freshly-trained bases only,
            # instead of letting one shim fail the whole SE stage
            trained = [m for m in self._models
                       if not isinstance(m, _RecoveredModel)]
            best_of_family: Dict[str, Any] = {}
            for r in self.leaderboard.rows:
                if not isinstance(r["_est"], _RecoveredModel):
                    best_of_family.setdefault(r["algo"], r["_est"])
            for name, base in (
                ("StackedEnsemble_BestOfFamily", list(best_of_family.values())),
                ("StackedEnsemble_AllModels", trained),
            ):
                if len(base) < 2:
                    self.event_log.log(
                        "skip", f"{name}: fewer than 2 stackable "
                        "(freshly-trained) base models")
                    continue
                try:
                    se = H2OStackedEnsembleEstimator(
                        base_models=base,
                        **({} if self.device is None
                           else dict(device=self.device)))
                    se.train(x=x, y=y, training_frame=training_frame)
                    se._automl_name = name
                    # SE has no CV — rank by training metrics as proxy
                    se.model.cross_validation_metrics = se.model.training_metrics
                    self.leaderboard.add(se, self._lb_frame)
                    self.event_log.log("model", f"built {name}")
                except Exception as e:
                    self.event_log.log("error", f"{name} failed: {e}")

        if len(self.leaderboard):
            self.leader = self.leaderboard[0]["_est"]
        self.event_log.log("done", f"{len(self.leaderboard)} models")
        return self

    def predict(self, frame: Frame) -> Frame:
        assert self.leader is not None, "AutoML has no leader; call train() first"
        return self.leader.predict(frame)

    _LEADERBOARD_METRICS = ("auc", "logloss", "mean_per_class_error",
                            "rmse", "mse", "mae")

    def get_best_model(self, algorithm: Optional[str] = None,
                       criterion: Optional[str] = None):
        """Best model overall or of one algorithm family
        (H2OAutoML.get_best_model)."""
        if self.leaderboard is None:
            raise ValueError("AutoML has no leaderboard; call train() first")
        rows = self.leaderboard.rows
        if criterion:
            if criterion not in self._LEADERBOARD_METRICS:
                raise ValueError(
                    f"criterion {criterion!r} not in leaderboard metrics "
                    f"{self._LEADERBOARD_METRICS}")
            decreasing = criterion in ("auc",)

            def sk(r):  # NaN-safe total order (same shape as Leaderboard._sort)
                v = r.get(criterion, float("nan"))
                bad = v is None or (isinstance(v, float) and np.isnan(v))
                return (bad, -v if (decreasing and not bad) else (v if not bad else 0))

            rows = sorted(rows, key=sk)
        for r in rows:
            if algorithm is None or r["algo"].lower() == algorithm.lower():
                return r["_est"]
        return None

    def get_leaderboard(self, extra_columns=None):
        return self.leaderboard
