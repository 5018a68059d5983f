"""The PyTorch port stands alone: importing it (or the chip smoke script)
loads neither `jax` nor the JAX package (the scan below covers every module
of the port, the serving engine, MOJO and runtime included), and its entry
points refuse to run on a device the caller did not ask for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "h2o3_tpu_torch").rglob("*.py"))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import h2o3_tpu_torch, h2o3_tpu_torch.estimators, h2o3_tpu_torch.convert\n"
        "import h2o3_tpu_torch.ops.hist_cuda, h2o3_tpu_torch.ops.histogram\n"
        "import h2o3_tpu_torch.models.shared_tree, chip_smoke\n"
        "import h2o3_tpu_torch.models.glm, h2o3_tpu_torch.models.estimator_engine\n"
        "import h2o3_tpu_torch.ops.score_cuda, h2o3_tpu_torch.mojo\n"
        "import h2o3_tpu_torch.ops.shap_cuda, h2o3_tpu_torch.models.tree_shap\n"
        "import h2o3_tpu_torch.serving, h2o3_tpu_torch.runtime.dkv\n"
        "import h2o3_tpu_torch.runtime.memory_ledger, h2o3_tpu_torch.runtime.retry\n"
        "import h2o3_tpu_torch.automl, h2o3_tpu_torch.models.grid\n"
        "import h2o3_tpu_torch.runtime.trainpool, h2o3_tpu_torch.runtime.phases\n"
        "import h2o3_tpu_torch.models.kmeans, h2o3_tpu_torch.models.pca\n"
        "import h2o3_tpu_torch.models.svd, h2o3_tpu_torch.models.glrm\n"
        "import h2o3_tpu_torch.models.naive_bayes, h2o3_tpu_torch.models.isotonic\n"
        "import h2o3_tpu_torch.models.gam, h2o3_tpu_torch.ops.splines\n"
        "import h2o3_tpu_torch.models.anovaglm\n"
        "import h2o3_tpu_torch.models.modelselection\n"
        "import h2o3_tpu_torch.models.coxph, h2o3_tpu_torch.models.psvm\n"
        "import h2o3_tpu_torch.models.rulefit\n"
        "import h2o3_tpu_torch.models.targetencoder, h2o3_tpu_torch.models.word2vec\n"
        "import h2o3_tpu_torch.models.aggregator, h2o3_tpu_torch.ops.quantiles\n"
        "import h2o3_tpu_torch.models.dataset_cache, h2o3_tpu_torch.runtime.persist\n"
        "import h2o3_tpu_torch.models.block_store, h2o3_tpu_torch.models.tree_stream\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'h2o3_tpu' or m.startswith('h2o3_tpu.'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port imported {res.stdout.strip()}"


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_source_imports_neither_jax_nor_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "h2o3_tpu"), f"{path}: {n}"


def test_entry_points_run_on_cuda_unless_asked():
    from h2o3_tpu_torch import device as devlib
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    assert devlib.resolve("cpu").type == "cpu"
    fr = Frame.from_numpy(np.column_stack([np.arange(64.0) % 7,
                                           np.arange(64) % 2]),
                          names=["a", "y"]).asfactor("y")
    est = H2OGradientBoostingEstimator(ntrees=1, max_depth=2)
    if torch.cuda.is_available():
        assert devlib.resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            devlib.resolve()
        with pytest.raises(RuntimeError, match="cuda"):
            est.train(y="y", training_frame=fr)
    est = H2OGradientBoostingEstimator(ntrees=1, max_depth=2, device="cpu")
    est.train(y="y", training_frame=fr)
    assert est.model.device.type == "cpu"


def test_glm_runs_on_cuda_unless_asked():
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    fr = Frame.from_numpy(np.column_stack([np.arange(64.0) % 7,
                                           np.arange(64) % 3]),
                          names=["a", "y"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            H2OGeneralizedLinearEstimator().train(y="y", training_frame=fr)
    est = H2OGeneralizedLinearEstimator(device="cpu")
    est.train(y="y", training_frame=fr)
    assert est.model.device.type == "cpu"


def test_set_device_is_the_process_default():
    from h2o3_tpu_torch import device as devlib

    devlib.set_device("cpu")
    try:
        assert devlib.resolve().type == "cpu"
        assert devlib.resolve("cpu").type == "cpu"
    finally:
        devlib.set_device(None)

