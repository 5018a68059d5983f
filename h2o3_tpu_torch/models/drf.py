"""H2ORandomForestEstimator — Distributed Random Forest, port of
`h2o3_tpu/models/drf.py`.

The reference's parameter surface and defaults (`hex/tree/drf/DRF.java`,
`h2o-py/h2o/estimators/random_forest.py`): bootstrap-style row sampling
(`sample_rate=0.632`), per-split column sampling (`mtries=-1`: √F for
classification, F/3 for regression), depth 20 (active-node compaction
below depth 12), vote-averaged scoring and out-of-bag training metrics.
The loop is `shared_tree.py`'s in DRF mode; on the GPU every histogram
pass of a fit with ``hist_method="pallas"`` runs the row-major CUDA kernel
(`csrc/hist.cu`, B2). XRT (``histogram_type="Random"``) parity is not
held yet (ROADMAP queue A, item 5).
"""

from __future__ import annotations

from .shared_tree import H2OSharedTreeEstimator


class H2ORandomForestEstimator(H2OSharedTreeEstimator):
    algo = "drf"
    _mode = "drf"
    _param_defaults = dict(
        ntrees=50,
        max_depth=20,
        min_rows=1.0,
        nbins=20,
        nbins_cats=1024,
        nbins_top_level=1024,
        mtries=-1,
        sample_rate=0.632,
        sample_rate_per_class=None,
        col_sample_rate_change_per_level=1.0,
        col_sample_rate_per_tree=1.0,
        min_split_improvement=1e-5,
        histogram_type="AUTO",
        hist_method="auto",  # auto|segment|pallas_factored|pallas (ops/histogram.py)
        distribution="AUTO",
        binomial_double_trees=False,
        score_tree_interval=0,
        balance_classes=False,
        class_sampling_factors=None,
        max_after_balance_size=5.0,
        build_tree_one_node=False,
        calibrate_model=False,
        calibration_frame=None,
        calibration_method="AUTO",
        reg_lambda=None,
    )


DRF = H2ORandomForestEstimator
