"""The memory-feasibility depth clamp logs the reference's warning.

Both packages lower `max_depth` until the deepest level's histograms
(~2^D·F·nbins·96 bytes) fit the histogram budget. The reference says so
with `Log.warn("max_depth=… clamped to …")`
(`h2o3_tpu/models/shared_tree.py`); the port logs the same text through
its own `runtime.log.Log`. The expected text is the reference's own f-string,
read from its source and formatted for the same (F, nbins, budget), not a
run of the reference's fit.
"""

import ast
from pathlib import Path

import numpy as np
import torch

from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import shared_tree
from h2o3_tpu_torch.runtime.log import Log

REF_SOURCE = (Path(__file__).resolve().parent.parent / "h2o3_tpu" / "models"
              / "shared_tree.py")


def _reference_message(**names) -> str:
    """The reference's clamp warning, formatted from its source."""
    for node in ast.walk(ast.parse(REF_SOURCE.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "warn" and node.args
                and isinstance(node.args[0], ast.JoinedStr)
                and "clamped to" in ast.unparse(node.args[0])):
            expr = ast.Expression(node.args[0])
            return eval(compile(expr, str(REF_SOURCE), "eval"), {}, names)
    raise AssertionError("the reference's clamp warning was not found")


def _frame():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4))
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    return Frame.from_numpy(np.column_stack([X, y]),
                            names=["a", "b", "c", "d", "y"]).asfactor("y")


def test_clamp_logs_the_reference_warning(monkeypatch):
    budget = 1_000_000
    monkeypatch.setattr(shared_tree, "_histogram_budget", lambda dev: budget)
    Log.clear()
    est = H2OGradientBoostingEstimator(ntrees=2, max_depth=8, seed=1,
                                       device="cpu")
    est.train(y="y", training_frame=_frame())
    # 2^D · F · nbins · 96 with F = 4, nbins = 21: 1,032,192 bytes at D = 7,
    # 516,096 at D = 6
    assert est.model.max_depth == 6
    want = _reference_message(tp={"max_depth": 8}, feas=6, F=4, nbins=21,
                              hbm_budget=budget)
    assert want.startswith("max_depth=8 clamped to 6: ")
    warns = [ln for ln in Log.get_logs() if " WARN " in ln]
    assert len(warns) == 1 and warns[0].endswith(" WARN " + want)
    assert est.model.forest[0].feat.shape[1] == 2 ** 7 - 1


def test_no_clamp_no_warning():
    Log.clear()
    est = H2OGradientBoostingEstimator(ntrees=1, max_depth=8, seed=1,
                                       device="cpu")
    est.train(y="y", training_frame=_frame())
    assert est.model.max_depth == 8
    assert not [ln for ln in Log.get_logs() if "clamped" in ln]


def test_histogram_budget_on_the_cpu():
    assert shared_tree._histogram_budget(torch.device("cpu")) == 8 << 30
