"""H2OGridSearch — hyperparameter search.

A copy of `h2o3_tpu/models/grid.py`, rewired to the port (reference
parity: `hex/grid/GridSearch.java`, `hex/grid/HyperSpaceWalker.java` —
Cartesian and RandomDiscrete walks, `search_criteria` max_models /
max_runtime_secs / seed — `hex/grid/Grid.java` and the client surface
`h2o-py/h2o/grid/grid_search.py`). Candidates train through the train
pool (`runtime/trainpool.py`) on the card by default: with `parallelism`
N, up to N builds are in flight and the models enter in submission order,
so the grid is the same at any N. RandomDiscrete shuffles the combos with
numpy's generator, as the reference does, so both packages walk the same
combos. Recovery (`recovery_dir`, `load`, the automatic resume) and
`save` write each model's artifact through the port's MOJO.

Not ported: a grid over a frame on an attached server (`_remote_train`)
needs the REST client, ROADMAP queue A, item 11.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..frame.frame import Frame


class _RecoveredModel:
    """Checkpointed grid model restored from its artifact: scores via the
    MOJO scorer; metric accessors replay the persisted values so a resumed
    grid's leaderboard includes pre-crash models."""

    def __init__(self, combo, path, metrics):
        import os

        self._grid_combo = combo
        self._path = path
        self._metrics = metrics
        self._scorer = None
        self.model_id = os.path.basename(path)[: -len(".h2o3")]
        self._parms = dict(combo)

    def predict(self, frame):
        if self._scorer is None:
            from ..mojo import load_model

            self._scorer = load_model(self._path)
        return self._scorer.predict(frame)

    def __getattr__(self, name):
        metrics = object.__getattribute__(self, "_metrics")
        if name in ("auc", "rmse", "mse", "logloss", "mae", "r2",
                    "mean_per_class_error", "pr_auc", "accuracy"):
            val = metrics.get(name, float("nan"))
            return lambda *a, **kw: val
        raise AttributeError(name)


def _jnorm(v):
    """Normalize a hyper-param structure into JSON space (tuples → lists,
    np scalars → str). Checkpoint state is round-tripped through json.dump,
    so every comparison between live and restored params must normalize
    both sides or an identical sweep fails to match its own records."""
    import json

    return json.loads(json.dumps(v, default=str))


class H2OGridSearch:
    def __init__(
        self,
        model,
        hyper_params: Dict[str, Sequence[Any]],
        grid_id: Optional[str] = None,
        search_criteria: Optional[Dict[str, Any]] = None,
        recovery_dir: Optional[str] = None,
        parallelism: int = 1,
    ):
        # `model` may be an estimator class or a template instance (h2o-py
        # accepts both)
        if isinstance(model, type):
            self.model_class = model
            self.base_parms: Dict[str, Any] = {}
        else:
            self.model_class = type(model)
            self.base_parms = {
                k: v for k, v in model._parms.items() if not k.startswith("_")
            }
        # plain-python values throughout: numpy scalars (np.arange hyper
        # ranges) would crash every JSON dump of grid state downstream
        self.hyper_params = {
            k: [x.item() if isinstance(x, np.generic) else x for x in v]
            for k, v in hyper_params.items()}
        self.grid_id = grid_id or f"grid_{int(time.time())}"
        self.search_criteria = dict(search_criteria or {"strategy": "Cartesian"})
        self.recovery_dir = recovery_dir
        # upstream H2OGridSearch `parallelism`: how many candidate builds
        # may be in flight at once (runtime/trainpool.py — results and the
        # resulting leaderboard stay in submission order, so any value
        # produces the same grid as parallelism=1)
        self.parallelism = max(int(parallelism or 1), 1)
        self.models: List = []
        self.failed: List[Dict] = []
        self._done_combos: List[Dict] = []  # restored on recovery

    # -- grid auto-recovery (hex/grid/GridSearch recovery + RecoveryHandler) -
    def _state_path(self):
        import os

        return os.path.join(self.recovery_dir, f"{self.grid_id}.grid.json")

    def _save_state(self):
        import json
        import os

        os.makedirs(self.recovery_dir, exist_ok=True)
        state = dict(
            grid_id=self.grid_id,
            model_module=self.model_class.__module__,
            model_class=self.model_class.__name__,
            base_parms={k: v for k, v in self.base_parms.items()
                        if isinstance(v, (int, float, str, bool, list, type(None)))},
            hyper_params=self.hyper_params,
            search_criteria=self.search_criteria,
            done_combos=self._done_combos,
            data_fp=getattr(self, "_data_fp", None),
        )
        with open(self._state_path(), "w") as f:
            json.dump(state, f)

    @staticmethod
    def load(recovery_dir: str, grid_id: str) -> "H2OGridSearch":
        """Re-import a checkpointed grid; already-built models are restored
        from their artifacts (so the leaderboard stays complete) and
        train() resumes only the remaining combos (h2o.load_grid / grid
        recovery_dir semantics)."""
        import importlib
        import json
        import os

        with open(os.path.join(recovery_dir, f"{grid_id}.grid.json")) as f:
            state = json.load(f)
        # a state the reference wrote names its own package: the port loads
        # the same estimator from its own
        mod = state["model_module"]
        if mod.split(".")[0] == "h2o3_tpu":
            mod = "h2o3_tpu_torch" + mod[len("h2o3_tpu"):]
        cls = getattr(importlib.import_module(mod), state["model_class"])
        g = H2OGridSearch(cls, state["hyper_params"], grid_id=state["grid_id"],
                          search_criteria=state["search_criteria"],
                          recovery_dir=recovery_dir)
        g.base_parms = state["base_parms"]
        # a record whose artifact is gone is dropped, not kept: keeping it
        # would exclude the combo from retraining while restoring nothing —
        # the model silently vanishes from the grid
        g._done_combos = []
        for d in state["done_combos"]:
            path = os.path.join(recovery_dir, d["file"])
            if os.path.exists(path):
                g._done_combos.append(d)
                g.models.append(_RecoveredModel(d["params"], path,
                                                d.get("metrics", {})))
        return g

    def _combos(self) -> List[Dict[str, Any]]:
        keys = list(self.hyper_params)
        combos = [
            dict(zip(keys, vals))
            for vals in itertools.product(*(self.hyper_params[k] for k in keys))
        ]
        strat = self.search_criteria.get("strategy", "Cartesian")
        if strat == "RandomDiscrete":
            seed = int(self.search_criteria.get("seed", 1234) or 1234)
            rng = np.random.default_rng(seed)
            rng.shuffle(combos)
            mm = self.search_criteria.get("max_models")
            if mm:
                combos = combos[: int(mm)]
        return combos

    def _auto_resume(self) -> None:
        """Sweep checkpoint/resume (hex.grid recovery): a killed sweep
        re-submitted with the same grid_id + recovery_dir + hyper space
        skips its already-trained combos — done-combo records and their
        model artifacts are restored from the state file WITHOUT requiring
        an explicit `H2OGridSearch.load` call. A state file whose hyper
        space or model class differs is someone else's sweep: it is left
        untouched and the grid trains from scratch (the done-combo filter
        would drop nothing anyway)."""
        import json as _json
        import os

        if (not self.recovery_dir or self._done_combos
                or not os.path.exists(self._state_path())):
            return
        try:
            with open(self._state_path()) as f:
                state = _json.load(f)
        except (ValueError, OSError):
            return
        from ..runtime.log import Log

        if (_jnorm(state.get("hyper_params")) != _jnorm(self.hyper_params)
                or state.get("model_class") != self.model_class.__name__
                or _jnorm(state.get("search_criteria"))
                != _jnorm(self.search_criteria)
                # data fingerprint: same sweep spec on DIFFERENT training
                # data must not restore the old data's models
                or state.get("data_fp") != getattr(self, "_data_fp", None)):
            Log.warn(f"grid {self.grid_id}: recovery state in "
                     f"{self.recovery_dir} does not match this sweep's "
                     "hyper space/model/data; ignoring it")
            return
        self._done_combos = []
        for d in state.get("done_combos") or []:
            path = os.path.join(self.recovery_dir, d["file"])
            if os.path.exists(path):
                self._done_combos.append(d)
                self.models.append(_RecoveredModel(d["params"], path,
                                                   d.get("metrics", {})))
            else:
                # dropped, not kept: a record without its artifact must
                # retrain, or the combo silently vanishes from the grid
                Log.warn(f"grid {self.grid_id}: artifact {d['file']} "
                         "missing from recovery_dir; combo will retrain")
        restored = len(self._done_combos)
        if restored:
            from ..runtime import trainpool as _tp

            _tp.record_resumed(restored)

    def train(self, x=None, y=None, training_frame: Optional[Frame] = None,
              parallelism: Optional[int] = None, **kw):
        if getattr(training_frame, "_is_remote", False):
            if kw:
                raise TypeError(
                    "remote grid search forwards x/y/training_frame only; "
                    f"unsupported kwargs for the wire path: {sorted(kw)}")
            return self._remote_train(x, y, training_frame)
        t0 = time.time()
        budget = float(self.search_criteria.get("max_runtime_secs", 0) or 0)
        if training_frame is not None:
            # shape + column names stand in for frame identity across
            # process restarts (auto-generated frame keys don't survive one)
            self._data_fp = dict(
                y=str(y),
                x=sorted(str(c) for c in x) if x is not None else None,
                nrow=int(training_frame.nrow),
                ncol=int(training_frame.ncol),
                columns=[str(c) for c in training_frame.names])
        self._auto_resume()
        # compare in JSON space: restored done-combos carry lists where the
        # live sweep may carry tuples — raw == would retrain every combo
        done = [_jnorm(d["params"]) for d in self._done_combos]
        combos = [c for c in self._combos() if _jnorm(c) not in done]
        par = max(int(parallelism if parallelism is not None
                      else self.parallelism), 1)

        import threading

        from ..runtime import trainpool as _tp

        ckpt_lock = threading.Lock()

        def _candidate(combo):
            def fn(job):
                parms = dict(self.base_parms)
                parms.update(combo)
                parms.pop("model_id", None)
                est = self.model_class(**parms)
                # the pool's child job rides into the estimator so /3/Jobs
                # cancellation of the grid reaches scoring-boundary safe
                # points inside the candidate's training loop
                est._external_job = job
                est.train(x=x, y=y, training_frame=training_frame, **kw)
                est._grid_combo = combo
                if self.recovery_dir:
                    # checkpoint failures must not mark the built model
                    # failed; a combo only counts done once its artifact
                    # exists on disk (seed semantics, now under a lock)
                    with ckpt_lock:
                        try:
                            self._record_done(est, combo)
                            self._save_state()
                        except (TypeError, OSError):
                            pass
                return est
            return fn

        pool = _tp.TrainPool(par, label=self.grid_id,
                             parent_job=getattr(self, "_external_job", None))
        recs = pool.run(
            [(f"combo{i}", _candidate(c)) for i, c in enumerate(combos)],
            stop_when=(lambda: bool(budget) and time.time() - t0 > budget))
        for combo, rec in zip(combos, recs):
            if rec.ok:
                self.models.append(rec.result)
            elif rec.status == "failed":
                # failed combos are recorded, the walk continues
                self.failed.append({"params": combo, "error": rec.error})
        return self

    def _record_done(self, est, combo) -> None:
        """Export one built model's artifact into recovery_dir and append
        its done-combo record. Filenames are combo-indexed (NOT model_id,
        which restarts per process and would clobber earlier runs')."""
        from ..mojo import save_model

        fname = f"{self.grid_id}_combo{len(self._done_combos)}.h2o3"
        save_model(est, self.recovery_dir, filename=fname, force=True)
        m = est.model
        metrics = dict(m.training_metrics._ser()
                       if m.training_metrics else {})
        if m.cross_validation_metrics is not None:
            metrics.update(m.cross_validation_metrics._ser())
        metrics = {k: v for k, v in metrics.items()
                   if isinstance(v, (int, float, str))}
        self._done_combos.append(
            dict(params=combo, file=fname, metrics=metrics))

    def save(self, grid_directory: str) -> str:
        """Export the trained grid — state file + one artifact per built
        model — so `h2o.load_grid(grid_directory)` restores it in another
        process (`h2o.save_grid`; upstream Grid.exportBinary +
        RecoveryHandler state). Grids trained WITHOUT a recovery_dir are
        supported: their done-combo records are built here from the live
        estimators."""
        import json as _json
        import os

        prev = self.recovery_dir
        # artifacts referenced by _done_combos live wherever they were last
        # exported (recovery_dir during train, or a prior save() target) —
        # they must travel with the state file that references them
        src_dir = prev or getattr(self, "_artifact_dir", None)
        self.recovery_dir = grid_directory
        try:
            if src_dir and os.path.abspath(src_dir) != os.path.abspath(
                    grid_directory):
                import shutil

                os.makedirs(grid_directory, exist_ok=True)
                for d in self._done_combos:
                    src = os.path.join(src_dir, d["file"])
                    if os.path.exists(src):
                        shutil.copy2(src, grid_directory)
            seen = {_json.dumps(d["params"], sort_keys=True, default=str)
                    for d in self._done_combos}
            for est in self.models:
                if isinstance(est, _RecoveredModel):
                    continue            # already in _done_combos
                combo = getattr(est, "_grid_combo", None)
                if combo is None:
                    raise TypeError(
                        "save_grid: grid model carries no combo record — "
                        "remotely-trained grids keep their artifacts on the "
                        "SERVER (download models individually)")
                if _json.dumps(combo, sort_keys=True, default=str) in seen:
                    continue
                self._record_done(est, combo)
            self._save_state()
            self._artifact_dir = grid_directory
        finally:
            self.recovery_dir = prev
        return grid_directory

    def _remote_train(self, x, y, training_frame):
        """Grid search against an attached server (POST `/99/Grid/{algo}`
        in the reference): the port has no REST client yet."""
        raise NotImplementedError(
            "grid search over a frame on an attached server needs the REST "
            "client (ROADMAP queue A, item 11)")

    # -- h2o-py surface ------------------------------------------------------
    def get_grid(self, sort_by: Optional[str] = None, decreasing: Optional[bool] = None):
        if sort_by:
            if decreasing is None:
                decreasing = sort_by.lower() in ("auc", "pr_auc", "accuracy", "r2")
            def _nfolds(m):
                if getattr(m, "_parms", None) is not None:
                    return m._parms.get("nfolds", 0)
                ps = getattr(m, "params", None)   # REST-backed models
                return (ps or {}).get("nfolds", 0) if isinstance(ps, dict) \
                    else 0

            xval = any(_nfolds(m) for m in self.models)

            def metric(m):
                try:
                    fn = getattr(m, sort_by, None)
                    if callable(fn):
                        v = fn(xval=xval)
                        return float("nan") if v is None else float(v)
                    if hasattr(m, "_m"):       # REST-backed: metrics dict
                        v = getattr(m._m(xval=xval), sort_by, None)
                        v = v() if callable(v) else v
                        if v is None:
                            v = m._m(xval=xval).get(sort_by)
                        return float("nan") if v is None else float(v)
                    return getattr(m.model._m(xval=xval), sort_by)
                except Exception:
                    return float("nan")

            self.models.sort(key=lambda m: (np.isnan(metric(m)), -metric(m) if decreasing else metric(m)))
        return self

    @property
    def model_ids(self) -> List[str]:
        return [m.model_id for m in self.models]

    def __iter__(self):
        return iter(self.models)

    def __len__(self):
        return len(self.models)

    def __getitem__(self, i):
        return self.models[i]

    def summary(self):
        return [
            {**getattr(m, "_grid_combo", {}), "model_id": m.model_id}
            for m in self.models
        ]
