"""Chip smoke for the PyTorch/CUDA port (h2o3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. The card's name and power limit (nvidia-smi).
2. Build the histogram kernel (csrc/hist.cu) with nvcc and time the build.
3. Kernel vs its plain PyTorch versions at the bench shape (N = 1,000,000
   rows, F = 28 features, B = 21 bins) for each of a depth-6 tree's six
   passes (the root pass with every row weighted; the sibling passes with
   about half the rows at zero weight, as `build_tree` hands them over),
   from seeded numpy inputs, on two code laws: uniform random codes and the
   smoke frame's own UniformAdaptive codes (most rows in a few central
   bins). The kernel must equal `hist_plain_fixed` bit for bit, give the
   same bits on a second launch, lie within the tolerance of `hist_plain`
   (f32), and lie no farther from an f64 sum than `hist_plain` does in each
   channel (w, g·w, h·w); both errors against f64 are printed per channel.
   Times: the kernel's on both laws, with the L2 flushed before each
   launch, the plain version's and one `index_add_` call's, and the bound.
   Then one deep pass (L = 1024, which the kernel splits into node slices)
   is checked the same way, untimed.
4. The main path through the port's public API: a 1M x 28 HIGGS-like
   frame, `asfactor("label")`, a depth-6 UniformAdaptive GBM of 20 trees,
   `auc()`, `predict` on 100k fresh rows. The launch counts are zeroed just
   before and read just after; every level must have launched the kernel,
   and `predict` the forest kernels once, on their resident plan.
5. Reference check on a small input: the same fit on cuda and on the CPU
   (plain versions, which the CPU tests hold against the JAX package) must
   give the same forest and predictions.
6. Where the time goes: one more fit at the main path's width, of
   PROFILE_TREES trees, under torch.profiler: the device's busy share of the
   fit's wall time, the kernels that take the most device time, and B1's
   device time summed over its kernels.
7. The row-major kernels (B2) vs their plain version at N = 1,000,000,
   F = 28, B = 21, row-major codes, at every distinct width of the DRF
   fit's level plan (L = 1, 2, 4, ..., 2^17 and the 4097 compaction slots;
   the root at L = 1 with the in-bag 63.2 % of rows weighted, the other
   passes about half), on a uniform node law and on a skewed one (half the
   weighted rows in one node, every fourth node empty): kernel times on
   both, plain and `index_add_` times and the bound on the uniform one.
8. The DRF path through the public API: the 1M x 28 frame, a default
   `H2ORandomForestEstimator(ntrees=DRF_TREES, hist_method="pallas")`
   (depth 20, clamped to the card's memory; mtries, row sampling,
   active-node compaction), OOB `auc()`, `predict` on 100k fresh rows. The
   dispatch must be "pallas" only and the B2 launches must equal the passes
   the level plan predicts plus those of the dense rebuilds, and `predict`
   must launch the forest kernels once, on their streamed plan; OOB and
   holdout AUC must reach DRF_AUC_FLOOR and equal DRF_AUCS (binary labels
   keep every histogram sum exact, so any right kernel builds this forest).
9. Reference check: a small DRF (4000 x 8, depth 14, level 13 in compact
   slots) on cuda and on the CPU gives the same forest and predictions.
10. Where the DRF fit's time goes: DRF_PROFILE_TREES trees under
   torch.profiler, with B2's device time summed over all its kernels.
11. The forest-scoring kernels (csrc/score.cu) on f32 rows with 5 % NaN, N
   in SCORE_ROWS, on the GBM's forest of phase 4 (20 trees, depth 6: the
   resident plan) and the DRF's of phase 8 (50 trees, depth 19, 2^20 - 1
   nodes a tree: the streamed plan), each over its score table (bytes and
   build time printed): equal bit for bit to `predict_forest_ordered` (the
   walk, its trees added in the kernels' order) and within 1e-5 * max(1,
   max |plain|) of `predict_forest_raw`; on a random forest with leaf
   values on a 2^-10 grid (every sum exact in any order) equal bit for bit
   to both. The plan that ran is printed. Times: the kernels and
   `predict_forest_raw` by CUDA events with the L2 flushed before each call
   (so the events time the device, not the host's enqueue), the device
   time of all the plan's kernels (walk and fold) from torch.profiler
   (calls back to back, L2 warm), and the bound: the forest's fields as
   the model stores them that the walks must read, each once (is_split of
   every reachable node above the last level, 1 byte; feat and thr of
   every reachable split node, 8; value of every reachable leaf, 4), X
   and the output once, over the memory rate.
12. Serving on the card: phase 4's GBM through `ScoringEngine.score` from 8
   threads, SERVE_REQUESTS requests of 1-300 rows (a seeded mix), then one
   request of 100,000 rows. Every response equals `model.predict` on its
   rows within 1e-6; the scorer cache has one miss and then hits, its warm
   buckets on the 64/128/256/512k ladder; one resident forest launch per
   batch; no batch was served by the
   failover's numpy fallback and no breaker opened. p50/p99 request latency
   and rows/s are printed beside the card.
13. MOJO round trip: the GBM and the DRF exported, reloaded with the port's
   `load_model`, and scored by its numpy walk (f64 sums) within 1e-5 of the
   card model's predictions.
14. Multinomial GBM at full width: a Covertype-shaped frame made from a
   seed (COV_ROWS x 54: 10 continuous, 4 wilderness and 40 soil indicator
   columns; 7 classes at Covertype's priors) with a COV_VALID-row
   validation frame from another seed, through
   `H2OGradientBoostingEstimator` at H2O's defaults with AutoML's stopping
   settings (COV_GBM). B1 must launch 7 x 5 passes per iteration built and
   nothing else; the scoring history has one row per 5 iterations with the
   training and validation logloss; the iteration the fit stopped at is
   the one `ScoreKeeper` gives on that history; `predict` on the validation
   frame launches the forest kernels 7 times (one per class forest, on the
   resident plan), its probability rows sum to 1 within 1e-6, and the
   validation logloss is below the class priors'. Prints the fit's binning,
   loop and scoring split beside the card. Then COV_PROFILE_TREES
   iterations of the same fit under torch.profiler (as phase 6).
15. Multinomial DRF, reduced to COV_DRF_TREES trees: phase 14's frame through
   `H2ORandomForestEstimator(hist_method="pallas")` at its other defaults
   (depth clamped by the card, mtries, row sampling, compaction), scored out
   of bag after every tree. B2's launches equal 7 x the level plan's passes
   per iteration plus the dense rebuilds'; `predict` launches the forest
   kernels 7 times, on the streamed plan; the OOB history is printed.
30. The multinomial GLM, run right after phase 15 on its frames (H2O's GLM
   documentation fits its multinomial example on Covertype):
   `H2OGeneralizedLinearEstimator(**MN_GLM)` (α = 0, λ = 1e-5: one
   optimum where the one-hot columns are collinear and a rare class
   separable) with the validation frame, fitted twice (the second
   checked): it stays on the L-BFGS path within its step cap, launches no
   hand-written kernel, its training and validation logloss are below the
   priors', its f64 gradient norm (the objective evaluated on the card in
   f64 at the returned β) at most 1e-3, its probability rows sum to 1
   within 1e-5, and `predict` of the validation frame equals the numpy
   MOJO scorer within 1e-5. Printed beside the card: the fit's split
   (host pack, H2D, expansion, L-BFGS, metrics), the steps and loss
   evaluations, the loss, the design's bytes, the metrics, and the busy
   share of a third, profiled fit (as phase 6). Then the serving engine
   answers SERVE_REQUESTS requests of 1..SERVE_MAX_ROWS validation rows
   from SERVE_THREADS threads, each within MN_SERVE_TOL of `predict`; a
   MN_FOLDS-fold CV of the same GLM (holdout rows finite, summing to 1);
   and a stack of it with a MN_FOLDS-fold 7-class GBM, COV_GBM cut to
   MN_GBM_TREES trees from 50 without early stopping (printed on a line
   of its own): the multinomial metalearner, a stack logloss below its
   weaker member's xval logloss and a validation logloss below the
   priors', `predict` of the validation frame launching the GBM's 7
   resident forest kernels and nothing else, its MOJO within 1e-5. Last,
   card against CPU on the CPU test's 4-class frame (4000 rows, λ = 0,
   MN_FOLDS folds): centred β within MN_BETA_TOL, predictions and
   holdouts within 1e-4.
16. Reference check on small inputs, card against CPU: a 4-class GBM and
   DRF (4000 x 8, well-separated classes), a GBM per new distribution
   (poisson, gamma, tweedie, laplace, quantile, huber) and a weighted
   binomial GBM with a validation frame and early stopping. The forest
   structure, the iteration count and the history rows must be equal;
   leaf values, predictions (relative to max(1, |p|) for the log links) and
   history metrics within 1e-5.

17. The Airlines logistic GLM headline (BASELINE.json config 2,
   `bench.py::bench_glm`'s generator copied here): 1,000,000 rows of
   DepTime, Distance and the enums Origin (100 levels), Dest (100), Month
   (12) and DayOfWeek (7), response IsDepDelayed (NO/YES) — 217 slopes and
   the intercept — through `H2OGeneralizedLinearEstimator(family=
   "binomial", solver="IRLSM", lambda_=0.0, compute_p_values=True)`,
   fitted twice (the first pays the solver libraries' first use; the
   second is checked). The fit must stay on the fused path and converge,
   every standard error be finite, the training AUC lie within 0.005 of
   the AUC of the generator's own probabilities, coef()["DepTime"] within
   5 % of the generator's 0.002, and `predict` on 100,000 fresh rows equal
   the numpy MOJO scorer within 1e-5. Printed beside the card: the fit's
   split (host pack, H2D, expansion, IRLS loop, p-values, metrics), the
   Gram's time per iteration by CUDA events against 2·N·p² over the f32
   peak and its error against an f64 Gram (TF32 would show), the
   expansion against its bytes bound, peak device memory.
18. λ search at full width: phase 17's frame with a 200,000-row validation
   frame, alpha 0.5, the default 30 λ. The path must have 30 λ, λ_best be
   the argmin of the printed validation deviances, and the host's f64
   re-solve at λ_best score no worse on the validation frame than the
   path's f32 β (within 1e-6 relative). Printed: wall, IRLS iterations and
   ISTA steps, and from the same fit under torch.profiler its kernel
   launches, the most launched kernels and the device's busy share of the
   unprofiled wall.
19. GLM reference check on small frames (4000 x 5: two numeric columns,
   three string enums), card against CPU: gaussian OLS, binomial, poisson,
   gamma, tweedie, ridge, lasso, non_negative, a weighted binomial, λ
   search with a validation frame and p-values. The same path, IRLS
   iterations and λ_best; β within 1e-4, predictions within 1e-5. Then the
   binomial GLM served by `ScoringEngine` from 4 threads, equal to
   `model.predict`, no batch served by the fallback.

Phases 20-23 run right after phase 13, while phase 4's GBM and phase 8's
DRF are alive; they explain them, and the build of phase 2 compiles
csrc/tree_shap.cu beside the other two sources.

20. Contributions at full width: `predict_contributions` of the GBM on
   SHAP_ROWS fresh rows (f32 values, 5 % NaN) and of the DRF on
   SHAP_DRF_ROWS rows, cut from SHAP_DRF_CUT_FROM (its 50 trees of depth 19
   cost ~10^9 FP64 operations a row). The TreeSHAP kernel
   (csrc/tree_shap.cu, a replay of each forest's path plan) must launch
   once per chunk of rows and nothing else; each model builds its plan at
   its first call and none at the second; on every explained row Σφ +
   BiasTerm equals the model's margin (the DRF's averaged) within 1e-5 ·
   max(1, |margin|); BiasTerm is constant. The kernel equals its plain
   version (`tree_shap_plain`) bit for bit: on all SHAP_ROWS of the GBM (2
   chunks, on the card), on SHAP_PLAIN_ROWS of them (on the card and on
   the CPU), on SHAP_SLICE_ROWS of the DRF's rows through the DRF tree
   with the fewest splits (depth 19, the kernel's depth-20 instance; plain
   on the CPU) and on a small DRF (4000 x 8, depth 10). Printed: the wall
   of each call (the DRF's twice: the second reads the model's kept bias
   term and plan), the bias term's time where the forest lies against a
   copy to the host, the plan's build time and bytes for both forests,
   the registers, stack and spill of each depth bucket (`-Xptxas -v`), the
   kernel's time by CUDA events at both shapes and on the DRF's first
   SHAP_DRF_SHORT_ROWS rows with the kept plan against
   its bound (the FP64 operations of `shap_ops` over the unfused FP64
   rate) and beside the replay's own count (`replay_ops`), the plain
   version's time on 512 rows and on the GBM's 100,000, the scratch peak.
21. Leaf assignment (both types), feature frequencies and, for the GBM,
   staged probabilities on LEAF_ROWS rows of both forests: Node_ID equals
   the CPU's `forest_leaves` on the same f64 rows, Path decodes to
   Node_ID, each row's frequencies sum to the splits on its paths, the
   last staged column is `predict`'s p1 within 1e-6. Times printed.
22. "contributions" and "leaves" served by `ScoringEngine` from
   SERVE_THREADS threads, SERVE_REQUESTS requests of 1-SERVE_MAX_ROWS rows
   at phase 12's `ServingConfig`: every response equals the model's method
   bit for bit, no batch is served by the fallback, contributions batches
   launch the kernel; then the MOJO scorer's `predict_contributions`
   (plain TreeSHAP on the host) within 1e-10 of the card's on
   MOJO_SHAP_ROWS rows. p50/p99 printed.
23. Small fits, card against CPU: a GBM with `offset_column` (bernoulli
   and gaussian, validation frames with their own offset) gives the same
   forest structure and predictions within 1e-5; a small GBM's and DRF's
   contributions equal the CPU's plain version on their forests within
   1e-10.

Phases 24-28 run last, on phase 4's frame made again from its seed:
cross-validation and the stacked ensemble. A wrapper set in this script
counts the package's `build_bins` calls and times each tree fit and each
holdout prediction.

24. The GBM of phase 4 with `nfolds=CV_FOLDS` and the holdout kept, on the
   fold-reuse path (one `build_bins`; B1 launched (CV_FOLDS + 1) x NTREES x
   DEPTH times and nothing else; no forest launch: the folds walk their
   holdout codes), then under `H2O3_CV_REBIN=1` (`build_bins` once a fit;
   the same B1 launches; 2 x CV_FOLDS resident forest launches, a fold's
   holdout and its validation metrics). Each: xval AUC ≥ 0.75, a
   probability on every row, the fold sizes the reference's Random
   assignment gives, fold 0's rows equal to its model's own prediction of
   them. The two paths' xval AUC and logloss within 0.03 and their
   holdouts' mean |diff| < 0.05 (the reference's bars). Printed: the
   parent's and each fold's wall, `bins_s` and `trees_s`, beside the card.
25. The DRF of phase 8 with `nfolds=CV_FOLDS`, cut to CV_DRF_TREES trees
   from DRF_TREES (printed on a line of its own): B2 launched the passes of
   every fit's level plan plus its dense rebuilds, and nothing else; one
   `build_bins`; the holdout checks of phase 24.
26. A binomial GLM (λ = 0) on the 28 columns with `nfolds=CV_FOLDS`: no
   hand-written kernel launched, the holdout finite; the parent's and
   each fold's split printed.
27. The stacked ensemble of phase 24's reuse-path GBM, phase 25's DRF and
   phase 26's GLM with the default metalearner: AUC ≥ the best base
   model's xval AUC − 0.03 (the reference's bar), metalearner β ≥ 0;
   `predict` of SE_ROWS fresh rows launches the forest kernels twice (the
   GBM's resident plan, the DRF's streamed one) and nothing else, and
   equals the ensemble's MOJO, scored by numpy, within 1e-5.
28. Card against CPU, 4000 x 8, CV_SMALL_FOLDS folds: the GBM and the DRF
   on both fold paths (fold forests equal node for node; holdouts and
   xval metrics within 1e-5, the DRF's AUC on holdouts rounded to 1e-6),
   the GLM (fold β within 1e-4, holdout within 1e-5), the ensemble
   (predictions within 1e-5).

29. 16-bit codes: benchm-ml's Airlines GBM (H2O's settings there:
   bernoulli, max_depth 16, learn_rate 0.01, nbins 100) on a generated
   1M-row frame of its eight features, Origin and Dest of 300 levels, so
   301 bins and 16-bit codes, cut to BM_TREES trees from 1000 (printed on
   a line of its own): its wall, `bins_s`, `upload_s`, `trees_s`, B1
   launches (every pass, nothing else), training AUC, `predict` and AUC on
   100,000 fresh rows; it must split Origin or Dest at a bin past 255.
   The DRF (defaults, "pallas", BM_DRF_TREES trees from 50): wall, clamped
   depth, B2 launches, OOB AUC. Both kernels at B = 301 and 1024, L = 1,
   64 and 4096: B1 bit-equal to `hist_plain_fixed` and no farther from
   f64 than `hist_plain`, B2 within rtol 1e-5 of `hist_plain_rows`, timed
   with the L2 flushed beside the bytes bound at 2 bytes a code; then
   every width of both fits' plans, checked and timed with the plain and
   `index_add_` versions. Card against CPU on a 20,000-row cut: GBM and
   DRF at depth 8, 5 trees, forest structure equal, leaf values and
   predictions within 1e-5.

31. XGBoost (`H2OXGBoostEstimator`), in five places. (d) right after phase
   18, on its Airlines frame: gblinear, binomial, GBLINEAR_ROUNDS rounds:
   the fit's split (host pack, H2D, rounds), AUC beside phase 17's GLM,
   logloss below the priors', β finite, no kernel launched, the MOJO
   within 1e-5. (b), (c) and (e) right after phase 27, on phase 4's frame:
   AutoML's XGBoost_1 (50 trees, depth 6, 256 QuantilesGlobal bins on
   8-bit codes): 300 B1 launches and nothing else, training AUC ≥ 0.75,
   `predict` of 100,000 fresh rows on the resident plan, contributions of
   10,000 rows with local accuracy ≤ 1e-5·max(1, |margin|) and the kernel
   bit-equal to `tree_shap_plain` on the card; B1 at B = 256 on that fit's
   codes at each pass of a depth-6 tree, held as in phase 3 (bit-equal to
   `hist_plain_fixed`, no farther from f64 than `hist_plain`) and timed
   with the plain, `index_add_` and bound times (the `hist_factored_b256`
   row of the kernel table); XGBoost_2's depth 10 cut to XGB_2_TREES
   trees, B1 per level width; DART, DART_ROUNDS rounds at rate_drop
   DART_RATE, both normalize types (rounds rescaled, AUC), and skip_drop=1
   at XGBoost_1's settings equal bit for bit to the first DART_ROUNDS
   trees of XGBoost_1. (a) after phase 29: `rank:ndcg` on a generated
   frame of MSLR-WEB30K's shape (`make_mslr_like`, one fold's training
   part: 18,919 queries, 2,262,675 documents, 136 features) at the
   reference's defaults and bench.py's 50 trees: the fit's split, the
   lambdarank pass's ms a round by CUDA events (g and h finite), B1's
   launches (300, nothing else) and ms a tree at that shape, NDCG@10 of
   the model above the zero model's (and the latent score's printed).
   (f) last: card against CPU on the CPU tests' small frames (gbtree
   binomial and multinomial, lambdarank, DART, gblinear): every row in the
   same leaf, leaf values and predictions within 1e-5, β within 1e-4; the
   card's gbtree and gblinear models served equal to `predict` within
   1e-6 with no fallback, and their MOJOs within 1e-5. The phase's wall,
   summed over its five places, is printed.

32. DeepLearning (`H2ODeepLearningEstimator`), last. (a) An MNIST-shaped
   frame (`make_mnist_like`: 60,000 training and 10,000 validation rows of
   784 integer pixel columns in 0-255, 10 balanced classes; the 67 corner
   pixels are zero in every row, as MNIST's are, so `ignore_const_cols`
   keeps 717 columns; about 19 % of the pixels are nonzero; each class a
   template of strokes, shifted by up to a pixel, with noise) fitted at
   the defaults (Rectifier, hidden [200, 200], ADADELTA, mini-batch 32)
   for DL_EPOCHS epochs (cut from 10): the fit's wall split into the host
   pack, upload, expansion, step loop and scoring events; steps and
   samples/s; launches a step and the device's busy share of a step from
   two profiled fits on DL_PROFILE_ROWS rows (DL_PROFILE_EPOCHS, one
   chunk each) differenced; no hand-written kernel launched; validation
   logloss below the priors' (ln 10) and the accuracy. (c) Its
   `predict` of the validation frame against its MOJO (within 1e-5), and
   one batch served through `ScoringEngine` (within 1e-6 of `predict`).
   (b) Card against CPU on small frames (Rectifier, Tanh, Maxout and
   RectifierWithDropout with input dropout, momentum SGD with l1 and l2,
   ADADELTA with max_w2, a regression, a weighted poisson fit and the
   autoencoder): the initial weights, a chunk's permutation and its first
   step's dropout masks equal bit for bit; predictions within DL_CARD_TOL;
   the autoencoder's `anomaly` on the card within DL_CARD_TOL of the
   CPU's. TF32 stays off. The phase's wall is printed.

Each path is driven with every launch count set to 0 just before it and
read just after (phase 12 is the scoring path's own; phases 14 and 15 zero
them again before their `predict`; phase 20 is the TreeSHAP path's; phases
24, 25 and 27's `predict` are the CV path's; phase 29's fits are each
their own; phase 30's stack `predict` is its own; each of phase 31's
fits, its `predict` and its contributions are their own; the GLM and
gblinear run none of the hand-written kernels, and phases 17, 18, 26, 30
and 31(d) fail if they launched one; so does phase 32's DeepLearning
fit).
TF32 must stay off
through phases 17-19, 30, 31(d) and 32. The last line is
{"ok": true, "device": {...}}; the line before it is the kernel table as
JSON.
"""

from __future__ import annotations

import json
import math
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
N_ROWS, N_FEAT, NBINS, DEPTH, NTREES = 1_000_000, 28, 21, 6, 20
LEVEL_WIDTHS = [1, 1, 2, 4, 8, 16]   # histogram passes of one depth-6 tree
# (L, sibling pass) per pass: a sibling pass weights only the left children
PASSES = [(L, i > 0) for i, L in enumerate(LEVEL_WIDTHS)]
DEEP_L = 1024                        # a depth-11 sibling pass: node slices
PROFILE_TREES = 5
# training AUC of the smoke's GBM on an H100 (PERF.md §5); B1's fixed-point
# sums differ from f32 ones in the last bits, so the fit must stay within
# 1e-3 of it
GBM_AUC = 0.780812
DRF_TREES = 50
# the DRF fit's plan: depth 20 clamped to 19 by the card's memory (phase 8
# reads the depth back), 4096 compact slots; every tree overflows them at 1M
# rows and is rebuilt with dense levels
DRF_DEPTH, DRF_CAP = 19, 4096
DRF_PROFILE_TREES = 2
# the reference DRF (JAX package, CPU) on the same generator at 100k rows:
# OOB AUC 0.80553, holdout AUC 0.81410 (tools/drf_auc_floor.py); less 0.01
DRF_AUC_FLOOR = 0.7955
# OOB and holdout AUC of that fit on an H100 with the reference's exact sums
# (PERF.md §5); a kernel that sums right gives them to 1e-6
DRF_AUCS = (0.832020, 0.837229)
# phase 11: rows scored per case; phase 12: requests of 1..SERVE_MAX_ROWS rows
SCORE_ROWS = (64, 512, 100_000, 1_000_000)
SERVE_REQUESTS, SERVE_MAX_ROWS, SERVE_THREADS, SERVE_BIG = 64, 300, 8, 100_000
# phases 14-15: a Covertype-shaped frame (UCI Covertype, Blackard & Dean,
# archive.ics.uci.edu/dataset/31): 10 continuous columns, 4 wilderness-area
# and 40 soil-type indicator columns, 7 classes at the data set's priors
COV_ROWS, COV_VALID, COV_K = 581_012, 116_202, 7
COV_PRIORS = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)
COV_NAMES = ([f"cont{i}" for i in range(10)] + [f"wild{i}" for i in range(4)]
             + [f"soil{i}" for i in range(40)])
# H2O's GBM defaults with AutoML's stopping settings
COV_GBM = dict(ntrees=50, max_depth=5, min_rows=10, nbins=20, learn_rate=0.1,
               stopping_rounds=3, stopping_metric="logloss",
               stopping_tolerance=1e-3, score_tree_interval=5, seed=42)
COV_DRF_TREES = 5
COV_PROFILE_TREES = 5


def make_higgs_like(n_rows: int, n_feat: int = 28, seed: int = 0):
    """The bench's HIGGS-like generator (bench.py::make_higgs_like)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    logits = (
        1.2 * X[:, 0]
        - 0.8 * X[:, 1]
        + 1.5 * X[:, 2] * X[:, 3]
        + 0.7 * np.sin(3 * X[:, 4])
        + 0.5 * (X[:, 5] ** 2 - 1)
    )
    y = (rng.random(n_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms_cold(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call,
    with the L2 cache flushed before each call and outside the events: a
    pass's inputs fit the card's 50 MB L2. The flush writes 1 GiB (~0.3 ms),
    so the host has enqueued all of fn()'s launches before the device
    reaches the first event, and the events time the device's work."""
    flush = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_device_ms(fn, match: str, reps: int = 10, warmup: int = 2):
    """(device ms per call of fn(), kernels recorded, {kernel: median ms})
    from torch.profiler's
    CUDA activity over `reps` calls back to back (L2 warm, no host enqueue
    in it): the median time of each kernel whose name holds `match`, summed
    over those names (a call launches each once). The profiler warms up for
    one step of `reps` calls before the step it records: without it, on an
    H100 with torch's CUPTI, it missed the first kernels of the window.
    A line says what it saw where it recorded other than one of each name
    per call; None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = list(prof.events())
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and match in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    n = sum(len(v) for v in by_name.values())
    if any(len(v) != reps for v in by_name.values()) or not by_name:
        seen = Counter(f"{e.device_type}:{e.name[:50]}" for e in events)
        print(f"profiler: {n} {match} kernels in {reps} calls "
              f"({ {k[:60]: len(v) for k, v in by_name.items()} }); events "
              f"seen: {seen.most_common(8)}", flush=True)
    if not by_name:
        return None, 0, {}
    per = {k: float(np.median(v)) / 1e3 for k, v in by_name.items()}
    return sum(per.values()), n, per


def fit_codes(dev):
    """(F, N) uint8 feature-major codes of the main path's frame as its fit
    bins them (UniformAdaptive, 20 bins and the NA bin)."""
    from h2o3_tpu_torch.frame.binning import build_bins

    X, _ = make_higgs_like(N_ROWS)
    bm = build_bins(X, nbins=NBINS, histogram_type="UniformAdaptive", seed=42)
    return torch.from_numpy(np.ascontiguousarray(bm.codes.T)).to(dev)


def pass_inputs(rng, dev, L, sibling, n=N_ROWS):
    """Node ids (n,) int32 and vals (3, n) f32 of one B1 pass: every row
    weighted at the root, about half in a sibling pass; g normal, h
    uniform."""
    w = (rng.random(n) < 0.5 if sibling
         else np.ones(n, bool)).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    vals = torch.from_numpy(np.stack([w, g * w, h * w])).to(dev)
    node = torch.from_numpy(rng.integers(0, L, n, dtype=np.int32)).to(dev)
    return node, vals


def channels(errs):
    return "/".join(f"{e:.1e}" for e in errs)


def check_b1(codes, node, vals, L, nbins=NBINS):
    """B1 at one pass against its plain versions; returns (max |kernel -
    hist_plain|, kernel's and hist_plain's max |err| against an f64 sum per
    channel). Raises unless the kernel equals `hist_plain_fixed` bit for
    bit, repeats its bits on a second launch, lies within rtol 1e-5 / atol
    1e-5·max of `hist_plain`, and lies no farther from f64 in any
    channel."""
    from h2o3_tpu_torch.ops import hist_cuda

    got = hist_cuda.hist_build(codes, node, vals, L, nbins)
    again = hist_cuda.hist_build(codes, node, vals, L, nbins)
    fixed = hist_cuda.hist_plain_fixed(codes, node, vals, L, nbins)
    ref = hist_cuda.hist_plain(codes, node, vals, L, nbins)
    f64 = hist_cuda.hist_plain(codes, node, vals, L, nbins, torch.float64)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"L={L}: two launches of B1 differ")
    if not torch.equal(got, fixed):
        raise AssertionError(
            f"L={L}: B1 differs from hist_plain_fixed by "
            f"{float((got - fixed).abs().max()):.3e}")
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    err = float((got - ref).abs().max())
    err_k, err_p = ([float(e) for e in
                     (x.double() - f64).abs().reshape(-1, 3).amax(0)]
                    for x in (got, ref))
    if any(k > p for k, p in zip(err_k, err_p)):
        raise AssertionError(
            f"L={L}: B1 lies farther from f64 than hist_plain in a channel "
            f"(w/g·w/h·w): {channels(err_k)} against {channels(err_p)}")
    return err, err_k, err_p


def kernel_vs_plain(dev):
    """Phase 3: per pass of a depth-6 tree, the kernel against its plain
    versions on the same seeded inputs, on uniform codes and on the fit's
    own codes; returns (per-pass rows, max |kernel - hist_plain|)."""
    from h2o3_tpu_torch.ops import hist_cuda

    rng = np.random.default_rng(7)
    laws = {"uniform": torch.from_numpy(
        rng.integers(0, NBINS, (N_FEAT, N_ROWS), dtype=np.uint8)).to(dev),
        "fit": fit_codes(dev)}
    rows, worst = [], 0.0
    for L, sibling in PASSES + [(DEEP_L, True)]:
        node, vals = pass_inputs(rng, dev, L, sibling)
        n_w = int((vals[0] != 0).sum())
        rec = dict(L=L, sibling=sibling, weighted_rows=n_w)
        for law, codes in laws.items():
            err, err_k, err_p = check_b1(codes, node, vals, L)
            worst = max(worst, err)
            tag = "" if law == "uniform" else "fit_"
            rec.update({f"{tag}max_abs_err": err,
                        f"{tag}f64_err": err_k, f"{tag}plain_f64_err": err_p})
            if L == DEEP_L:
                continue
            rec[f"{tag}ms"] = time_ms_cold(
                lambda: hist_cuda.hist_build(codes, node, vals, L, NBINS))
        if L == DEEP_L:
            p = hist_cuda.block_plan(L, NBINS, N_FEAT, N_ROWS)
            print(f"hist L={L} (deep, {p.grid[2]} node slices of "
                  f"{p.nodes_per_block}, {p.grid[0]} row blocks): equals "
                  f"hist_plain_fixed on both code laws; max |err| vs f64 "
                  f"(w/g·w/h·w) uniform {channels(rec['f64_err'])} "
                  f"(hist_plain {channels(rec['plain_f64_err'])}), fit codes "
                  f"{channels(rec['fit_f64_err'])} "
                  f"({channels(rec['fit_plain_f64_err'])})", flush=True)
            continue
        codes = laws["uniform"]
        rec["plain_ms"] = time_ms(
            lambda: hist_cuda.hist_plain(codes, node, vals, L, NBINS), reps=5)
        # one library call computing the same histogram: flat ids
        # f·L·B + node·B + code into an (F·L·B, 3) buffer
        ids = (torch.arange(N_FEAT, device=dev, dtype=torch.int64)[:, None]
               * (L * NBINS) + node.to(torch.int64)[None, :] * NBINS
               + codes.to(torch.int64)).reshape(-1)
        src = vals.t().repeat(N_FEAT, 1)
        buf = torch.zeros((N_FEAT * L * NBINS, 3), device=dev)
        rec["library_ms"] = time_ms(lambda: buf.zero_().index_add_(0, ids, src),
                                    reps=10)
        del ids, src, buf
        rec["bound_ms"], rec["bytes"] = bound_ms_of(n_w, L)
        rows.append(rec)
        print(f"hist L={L:2d} {'sibling' if sibling else 'root   '}: kernel "
              f"{rec['ms']:.4f} ms uniform, {rec['fit_ms']:.4f} ms fit codes "
              f"(L2 flushed); plain {rec['plain_ms']:.4f} ms, index_add_ "
              f"{rec['library_ms']:.4f} ms, bytes bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bytes'] / 1e6:.1f} MB); max |err| vs f64 (w/g·w/h·w) "
              f"uniform: kernel {channels(rec['f64_err'])}, hist_plain "
              f"{channels(rec['plain_f64_err'])}; fit codes: kernel "
              f"{channels(rec['fit_f64_err'])}, hist_plain "
              f"{channels(rec['fit_plain_f64_err'])}", flush=True)
    return rows, worst


def main_path(dev):
    """Phase 4: the port's main path at full width; returns its record, the
    frame and the model."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    X, y = make_higgs_like(N_ROWS)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    gbm = H2OGradientBoostingEstimator(
        ntrees=NTREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42, device=str(dev))
    hist_cuda.launches = hist_cuda.launches_rows = score_cuda.launches = 0
    score_cuda.launches_resident = score_cuda.launches_streamed = 0
    histogram.DISPATCH.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    gbm.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.time() - t0
    auc = float(gbm.auc())
    Xt, yt = make_higgs_like(100_000, seed=1)
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    t1 = time.time()
    pred = gbm.predict(ft)
    pred_s = time.time() - t1
    launches = hist_cuda.launches
    rows_launches = hist_cuda.launches_rows
    score_launches = score_cuda.launches
    score_plans = dict(resident=score_cuda.launches_resident,
                       streamed=score_cuda.launches_streamed)
    dispatch = dict(histogram.DISPATCH)
    p1 = np.asarray(pred.vec("1").data, np.float64)
    rec = dict(wall_s=wall, trees_per_s=NTREES / wall, auc=auc,
               holdout_auc=auc_exact(yt, p1), predict_s=pred_s,
               fit_timings=gbm.model.fit_timings,
               hist_launches=launches, score_launches=score_launches,
               score_plans=score_plans, dispatch=dispatch)
    print("main path: " + json.dumps(rec), flush=True)
    if auc < 0.75 or abs(auc - GBM_AUC) > 1e-3:
        raise AssertionError(f"training AUC {auc}: below 0.75 or more than "
                             f"1e-3 from {GBM_AUC}")
    if pred.names != ["predict", "0", "1"] or pred.nrow != 100_000:
        raise AssertionError(f"predict frame {pred.names} x {pred.nrow}")
    if not np.all(np.isfinite(p1)):
        raise AssertionError("predict returned non-finite probabilities")
    expect = NTREES * DEPTH
    if launches != expect or dispatch.get("pallas_factored") != expect \
            or set(dispatch) != {"pallas_factored"} or rows_launches:
        raise AssertionError(f"histogram dispatch {dispatch}, {launches} "
                             f"kernel launches; expected {expect} kernel "
                             "launches and no other method")
    if score_launches != 1 or score_plans != dict(resident=1, streamed=0):
        raise AssertionError(f"predict launched the forest kernels "
                             f"{score_launches} times ({score_plans}); "
                             "expected once, on the resident plan")
    return rec, fr, gbm.model


def profile_fit(est, fr, tag="profile", y="label", valid=None):
    """Phases 6, 10, 14 and 30: one fit of `est` on `fr` (and `valid`) under
    torch.profiler. Busy share = the union of the device's kernel and copy
    intervals over the fit's wall time (the profiler's own host overhead
    lengthens that wall, so the share reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        est.train(y=y, training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans, by_name = [], {}
    for e in prof.events():
        # a user annotation (torch.optim's `Optimizer.step#LBFGS.step`)
        # is mirrored on the device's timeline as a span that runs no work
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # B1's kernels (scale, main, fold) and B2's (count, scan, scatter and
    # the bucketed main kernel)
    b1 = {k[:80]: v / 1e3 for k, v in by_name.items() if "hist_fixed_" in k}
    b2 = {k[:80]: v / 1e3 for k, v in by_name.items() if "hist_rows_" in k}
    rec = dict(trees=getattr(est.model, "ntrees_built", None), wall_s=wall,
               device_busy_s=busy_us / 1e6,
               busy_share=busy_us / 1e6 / wall, device_events=len(spans),
               fit_timings=est.model.fit_timings,
               top_device_ms={k[:80]: v / 1e3 for k, v in top},
               b1_device_ms=sum(b1.values()), b1_kernels_ms=b1,
               b2_device_ms=sum(b2.values()), b2_kernels_ms=b2)
    print(f"{tag}: " + json.dumps(rec), flush=True)
    return rec


def small_reference_check(dev):
    """Phase 5: cuda and CPU fits of one small problem agree."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in (str(dev), "cpu"):
        est = H2OGradientBoostingEstimator(
            ntrees=5, max_depth=4, learn_rate=0.1, seed=42,
            histogram_type="UniformAdaptive", device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = est
    a, b = fits[str(dev)].model.forest[0], fits["cpu"].model.forest[0]
    for f in ("feat", "bin", "is_split"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"cuda and cpu forests differ in {f}")
    dv = float((a.value.cpu() - b.value).abs().max())
    pa = np.asarray(fits[str(dev)].predict(fr).vec("1").data)
    pb = np.asarray(fits["cpu"].predict(fr).vec("1").data)
    dp = float(np.abs(pa - pb).max())
    print(f"small reference check: forest structure equal, max |value diff| "
          f"{dv:.3e}, max |predict diff| {dp:.3e}", flush=True)
    if dv > 1e-5 or dp > 1e-5:
        raise AssertionError("cuda and cpu fits disagree beyond 1e-5")


def drf_widths():
    """(L, launches per smoke fit) for every distinct B2 width of the DRF
    fit: each tree's compact attempt and its dense rebuild."""
    from h2o3_tpu_torch.models.tree import histogram_level_plan

    n = Counter(L for _, L in histogram_level_plan(DRF_DEPTH, DRF_CAP)
                + histogram_level_plan(DRF_DEPTH))
    return sorted((L, DRF_TREES * c) for L, c in n.items())


def rows_fixture(rng, L, skewed):
    """Node ids (N,) int32 and weights (N,) f32 of one B2 pass: the in-bag
    63.2 % of rows weighted at L = 1, half the rows elsewhere; node ids
    uniform, or skewed: half the weighted rows in node L // 2, every fourth
    node empty."""
    w = rng.random(N_ROWS) < (0.632 if L == 1 else 0.5)
    node = rng.integers(0, L, N_ROWS)
    if skewed:
        node = np.where(node % 4 == 3, node - 1, node)
        node[w & (rng.random(N_ROWS) < 0.5)] = L // 2
    return node.astype(np.int32), w.astype(np.float32)


def bound_ms_of(n_weighted, L, n_feat=N_FEAT, nbins=NBINS, code_bytes=1,
                n_rows=N_ROWS):
    """Least time of one histogram pass (B1 or B2) on the card: the codes
    of the weighted rows (code_bytes a code), node ids and values of every
    row and the output, once each, over the memory rate (the adds take
    less); and those bytes."""
    nbytes = (n_weighted * n_feat * code_bytes + 16 * n_rows
              + L * n_feat * nbins * 3 * 4)
    flops = 3 * n_weighted * n_feat
    return max(nbytes / HBM_BYTES_PER_S, flops / 67e12) * 1e3, nbytes


def rows_vs_plain(dev):
    """Phase 7: the B2 kernels against `hist_plain_rows` at every width of
    the DRF plan, on seeded row-major inputs; returns (per-width rows,
    max |err|)."""
    from h2o3_tpu_torch.ops import hist_cuda

    rng = np.random.default_rng(11)
    codes = torch.from_numpy(
        rng.integers(0, NBINS, (N_ROWS, N_FEAT), dtype=np.uint8)).to(dev)
    g = rng.normal(size=N_ROWS).astype(np.float32)
    rows, worst = [], 0.0
    for L, n_fit in drf_widths():
        rec = dict(L=L, launches=n_fit, per_tree=n_fit / DRF_TREES)
        for law in ("uniform", "skewed"):
            node_np, w = rows_fixture(rng, L, law == "skewed")
            vals = torch.from_numpy(np.stack([w, g * w, w])).to(dev)
            node = torch.from_numpy(node_np).to(dev)
            got = hist_cuda.hist_build_rows(codes, node, vals, L, NBINS)
            ref = hist_cuda.hist_plain_rows(codes, node, vals, L, NBINS)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))
            err = float((got - ref).abs().max())
            del got, ref
            worst = max(worst, err)
            ms = time_ms(lambda: hist_cuda.hist_build_rows(codes, node, vals,
                                                           L, NBINS))
            if law == "skewed":
                rec.update(skewed_ms=ms, skewed_max_abs_err=err)
                continue
            plain_ms = time_ms(lambda: hist_cuda.hist_plain_rows(
                codes, node, vals, L, NBINS), reps=5)
            # one library call computing the same histogram: flat ids
            # f·L·B + node·B + code into an (F·L·B, 3) buffer
            ids = (torch.arange(N_FEAT, device=dev, dtype=torch.int64)[None, :]
                   * (L * NBINS) + node.to(torch.int64)[:, None] * NBINS
                   + codes.to(torch.int64)).reshape(-1)
            src = vals.t()[:, None, :].expand(N_ROWS, N_FEAT, 3).reshape(-1, 3)
            buf = torch.zeros((N_FEAT * L * NBINS, 3), device=dev)
            lib_ms = time_ms(lambda: buf.zero_().index_add_(0, ids, src),
                             reps=10)
            del ids, src, buf
            n_w = int(w.sum())
            bound_ms, nbytes = bound_ms_of(n_w, L)
            rec.update(weighted_rows=n_w, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bytes=nbytes,
                       max_abs_err=err)
        rows.append(rec)
        print(f"rows hist L={L:6d} ({n_fit:3d} per fit): kernel "
              f"{rec['ms']:.4f} ms uniform, {rec['skewed_ms']:.4f} ms skewed; "
              f"plain {rec['plain_ms']:.4f} ms, index_add_ "
              f"{rec['library_ms']:.4f} ms, bytes bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bytes'] / 1e6:.1f} MB), max |err| "
              f"{max(rec['max_abs_err'], rec['skewed_max_abs_err']):.3e}",
              flush=True)
    return rows, worst


def drf_path(dev, fr):
    """Phase 8: the DRF path at full width; returns its record and the
    model."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    drf = H2ORandomForestEstimator(ntrees=DRF_TREES, hist_method="pallas",
                                   seed=42, device=str(dev))
    hist_cuda.launches = hist_cuda.launches_rows = score_cuda.launches = 0
    score_cuda.launches_resident = score_cuda.launches_streamed = 0
    histogram.DISPATCH.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    drf.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, b1_launches = hist_cuda.launches_rows, hist_cuda.launches
    dispatch = dict(histogram.DISPATCH)
    model = drf.model
    oob_auc = float(drf.auc())
    Xt, yt = make_higgs_like(100_000, seed=1)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    t1 = time.time()
    pred = drf.predict(ft)
    pred_s = time.time() - t1
    score_launches = score_cuda.launches
    score_plans = dict(resident=score_cuda.launches_resident,
                       streamed=score_cuda.launches_streamed)
    p1 = np.asarray(pred.vec("1").data, np.float64)
    plan = histogram_level_plan(model.max_depth, model.compact_cap)
    expect = (DRF_TREES * len(plan)
              + model.dense_rebuilds * len(histogram_level_plan(model.max_depth)))
    rec = dict(wall_s=wall, trees_per_s=DRF_TREES / wall,
               max_depth_used=model.max_depth, compact_cap=model.compact_cap,
               compact_overflows=model.dense_rebuilds,
               dense_rebuilds=model.dense_rebuilds, oob_auc=oob_auc,
               holdout_auc=auc_exact(yt, p1), predict_s=pred_s,
               fit_timings=model.fit_timings, hist_launches=launches,
               score_launches=score_launches, score_plans=score_plans,
               planned_passes=expect,
               dispatch=dispatch,
               peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"DRF depth used: {model.max_depth} (requested 20)", flush=True)
    print("drf path: " + json.dumps(rec), flush=True)
    if min(oob_auc, rec["holdout_auc"]) < DRF_AUC_FLOOR:
        raise AssertionError(f"DRF AUC below the floor {DRF_AUC_FLOOR}: OOB "
                             f"{oob_auc}, holdout {rec['holdout_auc']}")
    if max(abs(oob_auc - DRF_AUCS[0]),
           abs(rec["holdout_auc"] - DRF_AUCS[1])) > 1e-6:
        raise AssertionError(f"DRF forest differs: OOB AUC {oob_auc}, holdout "
                             f"{rec['holdout_auc']}, expected {DRF_AUCS}")
    if pred.names != ["predict", "0", "1"] or pred.nrow != 100_000 \
            or not np.all(np.isfinite(p1)):
        raise AssertionError("DRF predict frame wrong or non-finite")
    if expect != sum(n for _, n in drf_widths()):
        raise AssertionError(f"the fit ran {expect} B2 passes; phase 7 "
                             "weighted its widths for another plan")
    if launches != expect or dispatch != {"pallas": expect} or b1_launches:
        raise AssertionError(f"DRF histogram dispatch {dispatch}, {launches} "
                             f"B2 launches, {b1_launches} B1 launches; "
                             f"expected {expect} B2 launches and no other")
    if score_launches != 1 or score_plans != dict(resident=0, streamed=1):
        raise AssertionError(f"DRF predict launched the forest kernels "
                             f"{score_launches} times ({score_plans}); "
                             "expected once, on the streamed plan")
    return rec, model


def small_drf_check(dev):
    """Phase 9: cuda and CPU DRF fits of one small problem agree. Binary
    labels keep every histogram sum exact in f32, whatever the order of the
    atomics, so the forests must be the same."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in (str(dev), "cpu"):
        est = H2ORandomForestEstimator(ntrees=5, max_depth=14, seed=42,
                                       hist_method="pallas", device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = est
    a, b = fits[str(dev)].model.forest[0], fits["cpu"].model.forest[0]
    for f in ("feat", "bin", "is_split"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"cuda and cpu DRF forests differ in {f}")
    dv = float((a.value.cpu() - b.value).abs().max())
    pa = np.asarray(fits[str(dev)].predict(fr).vec("1").data)
    pb = np.asarray(fits["cpu"].predict(fr).vec("1").data)
    dp = float(np.abs(pa - pb).max())
    da = abs(fits[str(dev)].auc() - fits["cpu"].auc())
    print(f"small DRF check: forest structure equal ({int(a.is_split.sum())} "
          f"splits), max |value diff| {dv:.3e}, max |predict diff| {dp:.3e}, "
          f"OOB AUC diff {da:.3e}", flush=True)
    if dv > 1e-5 or dp > 1e-5 or da > 1e-5:
        raise AssertionError("cuda and cpu DRF fits disagree beyond 1e-5")


def score_rows(rng, n):
    """(n, N_FEAT) f32 rows of the main path's generator, 5 % of the values
    NaN."""
    X, _ = make_higgs_like(n, seed=int(rng.integers(1 << 30)))
    X[rng.random(X.shape) < 0.05] = np.nan
    return X


def walk_nodes(forest, depth):
    """(reachable nodes above the last level, the split ones among them,
    reachable leaves) of a stacked forest walked `depth` steps: the roots
    are reachable, and both children of every reachable split node above
    the last level; a leaf is a reachable node that is not split or lies on
    the last level."""
    nt = forest.is_split.shape[0]
    above = split_n = leaves = 0
    live = torch.ones((nt, 1), dtype=torch.bool, device=forest.is_split.device)
    for d in range(depth):
        lo = 2 ** d - 1
        split = forest.is_split[:, lo:lo + 2 ** d] & live
        here, s = int(live.sum()), int(split.sum())
        above, split_n, leaves = above + here, split_n + s, leaves + here - s
        live = split.repeat_interleave(2, dim=1)
    return above, split_n, leaves + int(live.sum())


def score_bound_ms(forest, depth, n):
    """(least time of one forest-scoring call on the card in ms, its bytes):
    what the walks must read of the forest's fields as the model stores
    them, each byte once (is_split, 1 byte, of every reachable node above
    the last level; feat and thr, 8 bytes, of every reachable split node;
    value, 4 bytes, of every reachable leaf), and X and the output once
    each, over the memory rate (the compares take less). Computed from the
    `Tree` alone, whatever implements the walk."""
    above, split_n, leaves = walk_nodes(forest, depth)
    nbytes = above + 8 * split_n + 4 * leaves + (N_FEAT * 4 + 4) * n
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def score_vs_plain(dev, forests):
    """Phase 11: the forest kernels against their plain versions on each of
    `forests` ({name: (Tree, depth)}) at every N of SCORE_ROWS, and on a
    forest whose sums are exact; returns (rows, max |err| against
    `predict_forest_raw`)."""
    from h2o3_tpu_torch.models.tree import (Tree, heap_size,
                                            predict_forest_ordered,
                                            predict_forest_raw)
    from h2o3_tpu_torch.ops import score_cuda

    rng = np.random.default_rng(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    for name, (forest, depth) in forests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack = score_cuda.build_score_pack(forest, N_FEAT)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        pack_bytes = pack.nodes.numel() * pack.nodes.element_size()
        nt = int(forest.feat.shape[0])
        print(f"forest_score {name}: score table {pack_bytes} bytes "
              f"({pack_bytes / 1e6:.3f} MB), built in {pack_s * 1e3:.3f} ms",
              flush=True)
        for n in SCORE_ROWS:
            X = torch.from_numpy(score_rows(rng, n)).to(dev)
            plan = score_cuda.score_plan(nt, depth, N_FEAT, n, sms)
            got = score_cuda.forest_score(forest, X, depth, pack=pack)
            ordered = predict_forest_ordered(forest, X, depth)
            ref = predict_forest_raw(forest, X, depth)
            torch.cuda.synchronize()
            if not torch.equal(got, ordered):
                raise AssertionError(
                    f"forest kernel ({plan.kind} plan) on {name} at N={n} "
                    "differs from predict_forest_ordered: max |err| "
                    f"{float((got - ordered).abs().max()):.3e}")
            scale = max(1.0, float(ref.abs().max()))
            err = float((got - ref).abs().max())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"forest kernel on {name} at N={n}: max "
                                     f"|err| {err:.3e} > 1e-5 * {scale:.3g}")
            worst = max(worst, err)
            del ordered, ref
            big = n >= 100_000 and depth > 10

            def kernel():
                return score_cuda.forest_score(forest, X, depth, pack=pack)

            bound, nbytes = score_bound_ms(forest, depth, n)
            rec = dict(forest=name, trees=nt, depth=depth, N=n,
                       plan=plan._asdict(), max_abs_err=err, max_abs=scale,
                       equal_to_ordered=True, pack_bytes=pack_bytes,
                       pack_build_ms=pack_s * 1e3,
                       ms=time_ms_cold(kernel, reps=5 if big else 20),
                       plain_ms=time_ms_cold(lambda: predict_forest_raw(
                           forest, X, depth), reps=3 if big else 10,
                           warmup=1 if big else 3),
                       bound_ms=bound, bytes=nbytes)
            rec["device_ms"], rec["device_kernels"], per = kernel_device_ms(
                kernel, "forest_score_", reps=8 if big else 20)
            rec["device_ms_by_kernel"] = {
                re.search(r"forest_score_(\w+)", k).group(1): v
                for k, v in per.items()}
            del X, got
            rows.append(rec)
            dev_ms = ("not measured" if rec["device_ms"] is None
                      else f"{rec['device_ms']:.4f} ms over "
                      f"{rec['device_kernels']} kernels "
                      f"{json.dumps(rec['device_ms_by_kernel'])}")
            print(f"forest_score {name} ({nt} trees, depth {depth}) N={n}: "
                  f"{plan.kind} plan (grid {plan.grid}, {plan.smem} B shared"
                  + (f", {plan.chunk} trees x {plan.staged_levels} levels, "
                     f"{plan.rows_per_block} rows a block"
                     if plan.kind == "streamed" else "")
                  + f"): kernel {rec['ms']:.4f} ms (L2 flushed; profiler "
                  f"device time {dev_ms}, L2 warm), plain "
                  f"{rec['plain_ms']:.4f} ms, bytes bound {bound:.5f} ms "
                  f"({nbytes / 1e6:.1f} MB); equal to predict_forest_ordered; "
                  f"max |err| vs predict_forest_raw {err:.3e} (max |sum| "
                  f"{scale:.3g})", flush=True)
    # leaf values on a 2^-10 grid: every sum is exact in any order, so the
    # kernel's traversal must give the walk's sums to the bit
    nt, depth, n = 50, 10, 100_000
    T = heap_size(depth)
    split = rng.random((nt, T)) < 0.9
    split[:, 2 ** depth - 1:] = False
    dyadic = Tree(*[torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, N_FEAT, (nt, T), dtype=np.int32),
        np.zeros((nt, T), np.int32),
        rng.normal(size=(nt, T)).astype(np.float32), split,
        (rng.integers(-512, 512, (nt, T)) / 1024.0).astype(np.float32))])
    X = torch.from_numpy(score_rows(rng, n)).to(dev)
    kind = score_cuda.score_plan(nt, depth, N_FEAT, n, sms).kind
    got = score_cuda.forest_score(dyadic, X, depth)
    ref = predict_forest_raw(dyadic, X, depth)
    ordered = predict_forest_ordered(dyadic, X, depth)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and torch.equal(got, ordered)):
        raise AssertionError("forest kernel differs from the walk on a "
                             "dyadic forest: max |err| "
                             f"{float((got - ref).abs().max()):.3e}")
    print(f"forest_score dyadic forest ({nt} trees, depth {depth}, N={n}, "
          f"{kind} plan): equal to the walk and to predict_forest_ordered "
          "bit for bit", flush=True)
    return rows, worst


def serve_path(dev, model):
    """Phase 12: `ScoringEngine.score` on the card with phase 4's GBM from
    SERVE_THREADS threads, SERVE_REQUESTS requests of 1..SERVE_MAX_ROWS
    rows, then one of SERVE_BIG rows; returns its record."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    rng = np.random.default_rng(21)
    names = [f"f{i}" for i in range(N_FEAT)]

    def frame(n):
        return Frame.from_numpy(score_rows(rng, n), names=names)

    reqs = [frame(int(n)) for n in rng.integers(1, SERVE_MAX_ROWS + 1,
                                                SERVE_REQUESTS)]
    big = frame(SERVE_BIG)
    engine = ScoringEngine(ServingConfig())

    def call(fr):
        t0 = time.perf_counter()
        out = engine.score("gbm", model, fr)
        return out, time.perf_counter() - t0

    hist_cuda.launches = hist_cuda.launches_rows = score_cuda.launches = 0
    score_cuda.launches_resident = score_cuda.launches_streamed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVE_THREADS) as ex:
        results = list(ex.map(call, reqs))
    burst_s = time.perf_counter() - t0
    big_out, big_s = call(big)
    launches = score_cuda.launches
    resident = score_cuda.launches_resident
    hist_launches = hist_cuda.launches + hist_cuda.launches_rows
    snap = engine.snapshot()
    engine.shutdown()

    worst = 0.0
    for fr, (out, _) in zip(reqs + [big], results + [(big_out, big_s)]):
        want = model.predict(fr)
        if out.names != want.names or out.nrow != fr.nrow:
            raise AssertionError(f"served {out.names} x {out.nrow}, predict "
                                 f"gives {want.names} x {want.nrow}")
        worst = max(worst, float(np.abs(
            np.asarray(out.vec("1").data, np.float64)
            - np.asarray(want.vec("1").data, np.float64)).max()))
    lat = np.array([s for _, s in results]) * 1e3
    n_rows = sum(fr.nrow for fr in reqs)
    tot, cache, fo = snap["totals"], snap["cache"], snap["failover"]
    # where a request's time goes: its wait in the batch queue and its
    # batch's scoring call (frame work, copies, the kernel), per batch
    hist = snap["models"]["gbm"]["histograms"]
    wait, call_ms = hist["queue_wait_ms"], hist["device_ms"]
    buckets = sorted({b for e in cache["entries"] for b in e["warm_buckets"]})
    rec = dict(requests=len(reqs), rows=n_rows, threads=SERVE_THREADS,
               p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)),
               slowest_ms=sorted(lat.tolist())[-3:],
               slowest_request=int(lat.argmax()),
               queue_wait_ms=dict(mean=wait["mean"], max=wait["max"]),
               batch_call_ms=dict(mean=call_ms["mean"], max=call_ms["max"]),
               burst_s=burst_s, rows_per_s=n_rows / burst_s,
               big_rows=SERVE_BIG, big_ms=big_s * 1e3,
               big_rows_per_s=SERVE_BIG / big_s, batches=tot["batches"],
               batched_rows=tot["batched_rows"], score_launches=launches,
               max_abs_err=worst, cache_hits=cache["hits"],
               cache_misses=cache["misses"], warm_buckets=buckets,
               fallback_scores=tot["fallback_scores"],
               fallback_builds=fo["fallback_builds"],
               breakers=fo["breakers"], errors=tot["errors"],
               rejections=tot["rejections"])
    print("serving: " + json.dumps(rec), flush=True)
    print(f"serving on {card_line()}: {len(reqs)} requests of 1-"
          f"{SERVE_MAX_ROWS} rows from {SERVE_THREADS} threads: p50 "
          f"{rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms, "
          f"{rec['rows_per_s']:.0f} rows/s; one request of {SERVE_BIG} rows: "
          f"{rec['big_ms']:.3f} ms, {rec['big_rows_per_s']:.0f} rows/s",
          flush=True)
    if worst > 1e-6:
        raise AssertionError(f"served predictions differ from "
                             f"model.predict by {worst:.3e}")
    if cache["misses"] != 1 or cache["hits"] < 1:
        raise AssertionError(f"scorer cache: {cache['misses']} misses, "
                             f"{cache['hits']} hits; expected one miss, "
                             "then hits")
    if not all(b in (64, 128, 256) or b % 512 == 0 for b in buckets):
        raise AssertionError(f"warm buckets {buckets} off the ladder")
    if (fo["fallback_builds"] or tot["fallback_scores"] or fo["breakers"]
            or tot["errors"] or tot["rejections"]):
        raise AssertionError("the serving path degraded: " + json.dumps(
            dict(failover=fo, totals=tot)))
    if launches < 1 or launches != tot["batches"] or resident != launches \
            or hist_launches:
        raise AssertionError(f"{launches} forest kernel launches "
                             f"({resident} resident) for {tot['batches']} "
                             f"batches, {hist_launches} histogram launches")
    return rec


def mojo_round_trip(dev, models):
    """Phase 13: export each of `models` ({name: model}), reload it with
    the port's `load_model` and score 20,000 fresh rows with its numpy
    walk; returns {name: max |numpy - card|}."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(31)
    fr = Frame.from_numpy(score_rows(rng, 20_000),
                          names=[f"f{i}" for i in range(N_FEAT)])
    out = {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_mojo_") as d:
        for name, model in models.items():
            t0 = time.time()
            path = mojo.save_model(model, d, f"{name}.h2o3")
            save_s = time.time() - t0
            scorer = mojo.load_model(path)
            load_s = time.time() - t0 - save_s
            got = np.asarray(scorer.predict(fr).vec("1").data, np.float64)
            want = np.asarray(model.predict(fr).vec("1").data, np.float64)
            err = float(np.abs(got - want).max())
            out[name] = err
            print(f"mojo {name}: {os.path.getsize(path) / 1e6:.1f} MB, saved "
                  f"in {save_s:.2f} s, loaded in {load_s:.2f} s; numpy "
                  f"scorer vs card max |err| {err:.3e}", flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"MOJO of the {name} scores {err:.3e} "
                                     "away from the card model")
    return out


def make_covtype_like(n: int, seed: int):
    """(X (n, 54) f32, y (n,) class codes) shaped like UCI Covertype:
    elevation, aspect, slope, four distances, three hillshades and a fire
    distance; a one-hot wilderness area of 4 and soil type of 40; the cover
    type drawn from a softmax over class scores that depend mostly on
    elevation (as Covertype's do), then on the area, the soil and the
    distances, with intercepts set so the classes keep COV_PRIORS. The
    class effects come from a fixed seed, so every call draws from the same
    law."""
    law = np.random.default_rng(2024)
    centre = law.normal(size=COV_K) * 1.2
    w_cont = law.normal(size=(COV_K, 10)) * 0.35
    w_wild = law.normal(size=(COV_K, 4)) * 0.8
    w_soil = law.normal(size=(COV_K, 40)) * 0.8
    soil_p = law.dirichlet(np.full(40, 0.6))
    rng = np.random.default_rng(seed)
    cont = np.column_stack([
        rng.normal(2959, 280, n),                    # elevation
        rng.uniform(0, 360, n),                      # aspect
        rng.gamma(3.0, 4.7, n),                      # slope
        rng.gamma(1.5, 180, n),                      # horizontal to water
        rng.normal(46, 58, n),                       # vertical to water
        rng.gamma(1.8, 1300, n),                     # to roadways
        np.clip(rng.normal(212, 27, n), 0, 255),     # hillshade 9am
        np.clip(rng.normal(223, 20, n), 0, 255),     # hillshade noon
        np.clip(rng.normal(143, 38, n), 0, 255),     # hillshade 3pm
        rng.gamma(1.9, 1040, n),                     # to fire points
    ])
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n, p=soil_p)
    z = (cont - cont.mean(0)) / cont.std(0)
    score = (-(z[:, :1] - centre[None, :]) ** 2 + z @ w_cont.T
             + w_wild.T[wild] + w_soil.T[soil])
    # intercepts that give the priors in expectation (a few fixed-point
    # steps on the softmax's mean)
    b = np.log(np.asarray(COV_PRIORS) / sum(COV_PRIORS))
    target = np.exp(b)
    for _ in range(8):
        e = np.exp(score + b - (score + b).max(1, keepdims=True))
        b += np.log(target / (e / e.sum(1, keepdims=True)).mean(0))
    g = score + b - np.log(-np.log(rng.random((n, COV_K))))   # Gumbel max
    X = np.column_stack([cont, np.eye(4)[wild], np.eye(40)[soil]])
    return X.astype(np.float32), g.argmax(1)


def covtype_frames():
    """Phase 14's training and validation frames, the label a factor."""
    from h2o3_tpu_torch.frame.frame import Frame

    out = []
    for n, seed in ((COV_ROWS, 5), (COV_VALID, 6)):
        X, y = make_covtype_like(n, seed)
        out.append(Frame.from_numpy(
            np.column_stack([X, y.astype(np.float32)]),
            names=COV_NAMES + ["cover"]).asfactor("cover"))
    return out


def replay_stop(history, rounds, tol, key):
    """The iteration count `ScoreKeeper` stops at when it reads `key` of
    each row of `history` in turn (None: it never stops)."""
    from h2o3_tpu_torch.models.model_base import ScoreKeeper

    sk = ScoreKeeper(rounds, "logloss", tol)
    return next((r["number_of_trees"] for r in history if sk.record(r[key])),
                None)


def zero_counts():
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda, shap_cuda

    hist_cuda.launches = hist_cuda.launches_rows = score_cuda.launches = 0
    shap_cuda.launches = 0
    score_cuda.launches_resident = score_cuda.launches_streamed = 0
    histogram.DISPATCH.clear()
    torch.cuda.synchronize()


def multinomial_gbm_path(dev, fr, fv):
    """Phase 14: a 7-class GBM with a validation frame and early stopping
    at full width through the public API; returns its record and model."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    gbm = H2OGradientBoostingEstimator(device=str(dev), **COV_GBM)
    zero_counts()
    t0 = time.time()
    gbm.train(y="cover", training_frame=fr, validation_frame=fv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, dispatch = hist_cuda.launches, dict(histogram.DISPATCH)
    rows_launches = hist_cuda.launches_rows
    model = gbm.model
    built = model.ntrees_built
    hist = [dict(number_of_trees=r["number_of_trees"], logloss=r["logloss"],
                 validation_logloss=r["validation_logloss"])
            for r in model.scoring_history]
    zero_counts()
    t1 = time.time()
    pred = gbm.predict(fv)
    pred_s = time.time() - t1
    score_launches = score_cuda.launches
    score_plans = dict(resident=score_cuda.launches_resident,
                       streamed=score_cuda.launches_streamed)
    probs = np.column_stack([np.asarray(pred.vec(str(k)).data, np.float64)
                             for k in range(COV_K)])
    yv = np.asarray(fv.vec("cover").data)
    ytr = np.asarray(fr.vec("cover").data)
    prior = np.bincount(ytr, minlength=COV_K) / len(ytr)
    prior_logloss = float(-np.mean(np.log(prior[yv])))
    passes = len(histogram_level_plan(model.max_depth))
    expect = COV_K * passes * built
    stop_at = replay_stop(hist, COV_GBM["stopping_rounds"],
                          COV_GBM["stopping_tolerance"], "validation_logloss")
    rec = dict(rows=fr.nrow, valid_rows=fv.nrow, features=len(COV_NAMES),
               classes=COV_K,
               class_shares=(np.bincount(ytr, minlength=COV_K)
                             / len(ytr)).round(4).tolist(),
               wall_s=wall, iterations=built, trees=built * COV_K,
               fit_timings=model.fit_timings, hist_launches=launches,
               expected_hist_launches=expect, dispatch=dispatch,
               history=hist, replayed_stop=stop_at,
               train_logloss=float(model.logloss()),
               valid_logloss=float(model.logloss(valid=True)),
               valid_mean_per_class_error=float(
                   model.mean_per_class_error(valid=True)),
               prior_logloss=prior_logloss, predict_s=pred_s,
               score_launches=score_launches, score_plans=score_plans,
               max_row_sum_err=float(np.abs(probs.sum(1) - 1).max()))
    print("multinomial gbm: " + json.dumps(rec), flush=True)
    ft = model.fit_timings
    print(f"multinomial gbm on {card_line()}: {fr.nrow} x {len(COV_NAMES)}, "
          f"{COV_K} classes, {built} iterations ({built * COV_K} trees) in "
          f"{wall:.3f} s: binning {ft['bins_s']:.3f} s, upload "
          f"{ft['upload_s']:.3f} s, loop {ft['trees_s']:.3f} s, scoring "
          f"{ft['score_s']:.3f} s, metrics {ft['metrics_s']:.3f} s; "
          f"validation logloss {rec['valid_logloss']:.6f} (prior "
          f"{prior_logloss:.6f})", flush=True)
    if launches != expect or dispatch != {"pallas_factored": expect} \
            or rows_launches:
        raise AssertionError(f"multinomial GBM: {launches} B1 launches "
                             f"({dispatch}); expected {COV_K} x {passes} x "
                             f"{built} = {expect} and no other method")
    want_rows = [n for n in range(5, COV_GBM["ntrees"] + 1, 5) if n <= built]
    if [r["number_of_trees"] for r in hist] != want_rows or not all(
            np.isfinite([r["logloss"], r["validation_logloss"]]).all()
            for r in hist):
        raise AssertionError(f"scoring history rows {hist}; expected one "
                             f"per 5 iterations up to {built}")
    if (stop_at or COV_GBM["ntrees"]) != built:
        raise AssertionError(f"the fit stopped at {built}; ScoreKeeper on "
                             f"its history stops at {stop_at}")
    if score_launches != COV_K or score_plans["resident"] != COV_K:
        raise AssertionError(f"predict launched the forest kernels "
                             f"{score_launches} times ({score_plans}); "
                             f"expected {COV_K}, on the resident plan")
    if pred.names != ["predict"] + [str(k) for k in range(COV_K)] \
            or not np.all(np.isfinite(probs)) \
            or rec["max_row_sum_err"] > 1e-6:
        raise AssertionError(f"predict frame {pred.names}: non-finite or "
                             f"rows off 1 by {rec['max_row_sum_err']:.3e}")
    if not rec["valid_logloss"] < prior_logloss:
        raise AssertionError(f"validation logloss {rec['valid_logloss']} "
                             f"not below the prior's {prior_logloss}")
    return rec, model


def multinomial_drf_path(dev, fr, fv):
    """Phase 15: phase 14's frame through a 7-class DRF with B2, reduced
    to COV_DRF_TREES trees, scored out of bag at every iteration."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    drf = H2ORandomForestEstimator(ntrees=COV_DRF_TREES, hist_method="pallas",
                                   score_tree_interval=1, seed=42,
                                   device=str(dev))
    zero_counts()
    t0 = time.time()
    drf.train(y="cover", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, b1, dispatch = (hist_cuda.launches_rows, hist_cuda.launches,
                              dict(histogram.DISPATCH))
    model = drf.model
    plan = histogram_level_plan(model.max_depth, model.compact_cap)
    expect = (COV_K * model.ntrees_built * len(plan) + model.dense_rebuilds
              * len(histogram_level_plan(model.max_depth)))
    zero_counts()
    t1 = time.time()
    pred = drf.predict(fv)
    pred_s = time.time() - t1
    score_launches = score_cuda.launches
    score_plans = dict(resident=score_cuda.launches_resident,
                       streamed=score_cuda.launches_streamed)
    probs = np.column_stack([np.asarray(pred.vec(str(k)).data, np.float64)
                             for k in range(COV_K)])
    perf = model.model_performance(fv)
    hist = [dict(number_of_trees=r["number_of_trees"], oob_logloss=r["logloss"])
            for r in model.scoring_history]
    rec = dict(wall_s=wall, iterations=model.ntrees_built,
               trees=model.ntrees_built * COV_K,
               max_depth_used=model.max_depth, compact_cap=model.compact_cap,
               dense_rebuilds=model.dense_rebuilds,
               fit_timings=model.fit_timings, hist_launches=launches,
               expected_hist_launches=expect, dispatch=dispatch,
               oob_history=hist, oob_logloss=float(model.logloss()),
               valid_logloss=float(perf.logloss),
               valid_mean_per_class_error=float(perf.mean_per_class_error),
               predict_s=pred_s, score_launches=score_launches,
               score_plans=score_plans,
               max_row_sum_err=float(np.abs(probs.sum(1) - 1).max()),
               peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("multinomial drf: " + json.dumps(rec), flush=True)
    if launches != expect or dispatch != {"pallas": expect} or b1:
        raise AssertionError(f"multinomial DRF: {launches} B2 launches "
                             f"({dispatch}), {b1} B1; expected {expect}")
    if score_launches != COV_K or score_plans["streamed"] != COV_K:
        raise AssertionError(f"DRF predict launched the forest kernels "
                             f"{score_launches} times ({score_plans}); "
                             f"expected {COV_K}, on the streamed plan")
    if [r["number_of_trees"] for r in hist] != list(
            range(1, COV_DRF_TREES + 1)) or not np.all(np.isfinite(
                [r["oob_logloss"] for r in hist])):
        raise AssertionError(f"DRF OOB history {hist}")
    if not np.all(np.isfinite(probs)) or rec["max_row_sum_err"] > 1e-6:
        raise AssertionError("DRF probabilities non-finite or off 1")
    return rec, model


def _pair_fit(est_cls, d, params, fr, fv=None, y="label"):
    est = est_cls(device=d, **params)
    est.train(y=y, training_frame=fr, validation_frame=fv)
    return est.model


def _forest_diff(a, b):
    """(number of (class, tree, node) whose feature, bin or split flag
    differ; max |leaf value diff|) of two models' class forests."""
    nodes, dv = 0, 0.0
    for fa, fb in zip(a.forest, b.forest):
        diff = torch.zeros_like(fb.is_split)
        for f in ("feat", "bin", "is_split"):
            diff |= getattr(fa, f).cpu() != getattr(fb, f)
        nodes += int(diff.sum())
        dv = max(dv, float((fa.value.cpu() - fb.value).abs().max()))
    return nodes, dv


def _pred_diff(a, b, fr):
    pa, pb = a.predict(fr), b.predict(fr)
    cols = pa.names[1:] if len(pa.names) > 1 else pa.names
    return max(float(np.abs(np.asarray(pa.vec(c).data, np.float64)
                            - np.asarray(pb.vec(c).data, np.float64)).max())
               for c in cols)


def small_extension_checks(dev):
    """Phase 16: the new modules on a small input, card against CPU (whose
    plain versions the CPU tests hold against the JAX package). Must match
    exactly: the forest structure of the 4-class DRF (one-hot sums are
    exact in any order) and of the well-separated 4-class GBM, of each
    distribution's GBM, and of the weighted GBM, with its stopping iteration
    and scoring history rows. Must agree within 1e-5: predictions (relative
    to max(1, |p|) for the log-link families), history metrics and leaf
    values, these within 1e-4 for the 4-class GBM: its softmax gradients
    are not dyadic, and a leaf value -G/(H+λ) carries the CPU's f32
    histogram rounding (the sequential sum's, ~eps·sqrt(n)·|partial sum|),
    which B1's fixed-point sums do not have. Every case is fitted and
    printed before the first failure is raised."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(41)
    names = [f"f{i}" for i in range(8)] + ["label"]
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    yc = np.argmax(2 * X[:, :4] + 0.5 * rng.normal(size=(4000, 4)), axis=1)
    fc = Frame.from_numpy(np.column_stack([X, yc]), names=names).asfactor("label")
    cases = [("gbm_4class", H2OGradientBoostingEstimator,
              dict(ntrees=5, max_depth=4, seed=42), fc, None),
             ("drf_4class", H2ORandomForestEstimator,
              dict(ntrees=5, max_depth=10, seed=42, hist_method="pallas"),
              fc, None)]
    mu = np.exp(0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * np.sin(2 * X[:, 2]))
    for dname in ("poisson", "gamma", "tweedie", "laplace", "quantile",
                  "huber"):
        if dname == "poisson":
            yr = rng.poisson(mu)
        elif dname in ("gamma", "tweedie"):
            yr = rng.gamma(2.0, mu / 2.0)
        else:
            yr = 3 * X[:, 0] + np.sin(2 * X[:, 1]) + rng.standard_t(3, 4000)
        fr = Frame.from_numpy(np.column_stack([X, yr]), names=names)
        cases.append((dname, H2OGradientBoostingEstimator,
                      dict(ntrees=5, max_depth=4, seed=42, distribution=dname,
                           tweedie_power=1.3, quantile_alpha=0.8), fr, None))
    Xw, yw = make_higgs_like(3000, n_feat=8, seed=3)
    Xv, yv = make_higgs_like(1500, n_feat=8, seed=4)
    wn = names + ["w"]
    w = rng.choice([0.5, 1.0, 2.0], 3000)
    fw = Frame.from_numpy(np.column_stack([Xw, yw, w]), names=wn).asfactor("label")
    fwv = Frame.from_numpy(np.column_stack([Xv, yv, np.ones(1500)]),
                           names=wn).asfactor("label")
    cases.append(("gbm_weighted_valid_stopping", H2OGradientBoostingEstimator,
                  dict(ntrees=40, max_depth=3, learn_rate=0.5, seed=42,
                       weights_column="w", stopping_rounds=2,
                       stopping_tolerance=0.01, score_tree_interval=3),
                  fw, fwv))
    out, bad = {}, []
    for name, cls, params, fr, fv in cases:
        a = _pair_fit(cls, str(dev), params, fr, fv)
        b = _pair_fit(cls, "cpu", params, fr, fv)
        nodes, dv = _forest_diff(a, b)
        scale = 1.0
        dp = _pred_diff(a, b, fr)
        if params.get("distribution") in ("poisson", "gamma", "tweedie"):
            p = np.asarray(b.predict(fr).vec("predict").data, np.float64)
            scale = max(1.0, float(np.abs(p).max()))
        ha = [(r["number_of_trees"], r.get("validation_logloss"))
              for r in a.scoring_history]
        hb = [(r["number_of_trees"], r.get("validation_logloss"))
              for r in b.scoring_history]
        dh = max([abs(x[1] - y[1]) for x, y in zip(ha, hb)
                  if x[1] is not None] or [0.0])
        rec = dict(iterations=(a.ntrees_built, b.ntrees_built),
                   differing_nodes=nodes, max_value_diff=dv,
                   max_predict_diff=dp, predict_scale=scale,
                   history_rows=[x[0] for x in ha], max_history_diff=dh)
        out[name] = rec
        print(f"small check {name}: " + json.dumps(rec), flush=True)
        if nodes or a.ntrees_built != b.ntrees_built \
                or [x[0] for x in ha] != [x[0] for x in hb]:
            bad.append(f"{name}: cuda and cpu fits differ in structure "
                       f"({nodes} nodes), iterations or history rows")
        value_tol = 1e-4 if name == "gbm_4class" else 1e-5
        if dv > value_tol or dp > 1e-5 * scale or dh > 1e-5:
            bad.append(f"{name}: cuda and cpu fits disagree beyond the "
                       "tolerance")
    if out["gbm_weighted_valid_stopping"]["iterations"][0] >= 40:
        bad.append("the weighted GBM's stop did not fire")
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# phases 17-18: bench.py::bench_glm's Airlines-like frame at the bench's
# size (1M rows, 217 slopes and the intercept); a validation frame and
# fresh rows for predict from other seeds
AIR_ROWS, AIR_VALID, AIR_TEST, AIR_NLAMBDA = 1_000_000, 200_000, 100_000, 30
# H100 SXM f32 peak outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12
GLM_GRAM_REPS = 10


def make_airlines_like(n: int, seed: int):
    """bench.py::bench_glm's generator: DepTime, Distance, the enums Origin
    (100 levels), Dest (100), Month (12) and DayOfWeek (7), and the
    response IsDepDelayed (NO/YES) drawn from a logistic model in them.
    Returns (frame, the generator's P(YES) per row, the 0/1 labels)."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    dep = rng.integers(0, 2400, n).astype(np.float64)
    dist = np.abs(rng.normal(800, 500, n))
    origin = rng.integers(0, 100, n)
    dest = rng.integers(0, 100, n)
    month = rng.integers(0, 12, n)
    dow = rng.integers(0, 7, n)
    eff = (0.002 * (dep - 1200) + 0.4 * (origin % 7 == 0)
           - 0.3 * (dest % 11 == 0) + 0.1 * (dow >= 5))
    p = 1 / (1 + np.exp(-eff))
    y = (rng.random(n) < p).astype(int)
    fr = Frame.from_dict(
        {"DepTime": dep, "Distance": dist,
         "Origin": np.char.add("O", origin.astype(str)),
         "Dest": np.char.add("D", dest.astype(str)),
         "Month": month.astype(str), "DayOfWeek": dow.astype(str),
         "IsDepDelayed": np.where(y == 1, "YES", "NO")},
        column_types={"Origin": "enum", "Dest": "enum", "Month": "enum",
                      "DayOfWeek": "enum", "IsDepDelayed": "enum"})
    return fr, p, y


def tf32_off():
    """The GLM phases need true f32 products (the reference's
    Precision.HIGHEST): TF32 would move β by ~1e-3 relative."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(
            "TF32 is on: allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
            f"precision {torch.get_float32_matmul_precision()!r}")


def kernel_counts():
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda, shap_cuda

    return dict(hist=hist_cuda.launches, hist_rows=hist_cuda.launches_rows,
                score=score_cuda.launches, shap=shap_cuda.launches)


def _design_bytes(dinfo, n: int, p: int) -> int:
    """Bytes the design's expansion must move: its compact packs read
    once (numeric columns at their transfer width, int32 codes) and the
    (n, p) f32 design written once."""
    width = {0: 1, 1: 2, 2: 4}
    packed = sum(width[g] for g in dinfo._transfer_groups)
    packed += 4 * sum(1 for k, _, _ in dinfo._spec if k == "cat")
    return n * packed + 4 * n * p


def airlines_glm_path(dev, fr, p_true, y):
    """Phase 17: the Airlines logistic headline through the public API;
    returns its record."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.models import estimator_engine, glm
    from h2o3_tpu_torch.models.metrics import ModelMetricsBinomial

    tf32_off()

    def fit():
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        est = H2OGeneralizedLinearEstimator(
            family="binomial", solver="IRLSM", lambda_=0.0,
            compute_p_values=True, device=str(dev))
        est.train(y="IsDepDelayed", training_frame=fr)
        torch.cuda.synchronize()
        return (est.model, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev), kernel_counts())

    # the first fit pays the first use of the solver libraries and of the
    # expansion's kernels; the second is the steady state, and is checked
    first, first_wall, _, _ = fit()
    m, wall, peak, counts = fit()
    plan, ft = m.fitplan, m.fit_timings
    auc_true = ModelMetricsBinomial.make(y, p_true).auc
    coef = m.coef()
    # the Gram alone at the fit's shape and β, by CUDA events, against its
    # f32 operation bound and against an f64 Gram (TF32 would be ~1e-3 off)
    dinfo, Xd = estimator_engine.design_matrix(
        fr, m.x, standardize=True, add_intercept=True, device=dev)
    yd = torch.from_numpy(np.asarray(fr.vec("IsDepDelayed").data,
                                     np.float32)).to(dev)
    wd = torch.ones_like(yd)
    bd = torch.as_tensor(np.asarray(m.beta, np.float32), device=dev)
    gram_ms = time_ms(lambda: glm._gram_step(Xd, yd, wd, bd, "binomial"),
                      reps=GLM_GRAM_REPS, warmup=2)
    gram, _ = glm._gram_step(Xd, yd, wd, bd, "binomial")
    X64 = Xd.double()
    del Xd
    mu = torch.sigmoid(X64 @ bd.double())
    ww = torch.clamp(mu * (1 - mu), min=1e-10)
    gram64 = (X64 * ww[:, None]).T @ X64
    del X64, mu, ww
    gram_err = float(((gram.double() - gram64).abs().max()
                      / gram64.abs().max()))
    N, P = AIR_ROWS, len(dinfo.coef_names) + 1
    gram_bound = 2 * N * P * P / F32_FLOPS_PER_S * 1e3
    expand_bound = _design_bytes(dinfo, N, P) / HBM_BYTES_PER_S * 1e3
    del gram64
    # predict on fresh rows against the numpy MOJO scorer (f64)
    ft_fr, _, _ = make_airlines_like(AIR_TEST, 1)
    t1 = time.perf_counter()
    pred = m.predict(ft_fr)
    predict_s = time.perf_counter() - t1
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_glm_") as d:
        scorer = mojo.load_model(mojo.save_model(m, d, "glm.h2o3"))
        got = scorer.predict(ft_fr)
    mojo_err = float(np.abs(np.asarray(got.vec("YES").data, np.float64)
                            - np.asarray(pred.vec("YES").data,
                                         np.float64)).max())
    rec = dict(rows=N, p=P, path=plan["path"], iterations=plan["iterations"],
               converged=plan["converged"], deltas=plan["deltas"],
               auc=m.auc(), auc_true=auc_true,
               coef_DepTime=coef["DepTime"],
               stderr_finite=bool(np.isfinite(m.stderr).all()),
               wall_s=wall, timings=ft, peak_bytes=peak,
               first_fit=dict(wall_s=first_wall, timings=first.fit_timings,
                              iterations=first.fitplan["iterations"]),
               gram_ms=gram_ms, gram_bound_ms=gram_bound,
               gram_rel_err_vs_f64=gram_err,
               expand_bound_ms=expand_bound, predict_rows=AIR_TEST,
               predict_s=predict_s, mojo_max_abs_err=mojo_err,
               kernel_counts=counts)
    print("glm airlines: " + json.dumps(rec), flush=True)
    print(f"glm airlines on {card_line()}: {N} x {P}, {plan['iterations']} "
          f"IRLS iterations ({plan['path']}), fit {wall:.3f} s = design "
          f"{ft['pack_s']:.3f} host pack + {ft['h2d_s']:.3f} H2D + "
          f"{ft['expand_s'] * 1e3:.3f} ms expansion (bound {expand_bound:.4f} ms), "
          f"IRLS loop {ft['irls_s']:.3f}, p-values {ft['pvalues_s']:.3f}, "
          f"metrics {ft['metrics_s']:.3f}; Gram {gram_ms:.3f} ms per "
          f"iteration against its f32 bound {gram_bound:.3f} ms; peak "
          f"device memory {peak / 2**30:.2f} GiB; AUC {m.auc():.6f} against "
          f"the generator's {auc_true:.6f}; the first fit {first_wall:.3f} s",
          flush=True)
    bad = []
    if plan["path"] != "fused" or not plan["converged"]:
        bad.append(f"the fit left the fused path or did not converge: {plan}")
    if abs(m.auc() - auc_true) > 0.005:
        bad.append(f"training AUC {m.auc():.6f} is more than 0.005 from "
                   f"the generator's {auc_true:.6f}")
    if abs(coef["DepTime"] - 0.002) > 0.05 * 0.002:
        bad.append(f"coef DepTime {coef['DepTime']:.6g} is more than 5 % "
                   "from the generator's 0.002")
    if not rec["stderr_finite"]:
        bad.append("a standard error is not finite")
    if not mojo_err <= 1e-5:
        bad.append(f"predict differs from the MOJO scorer by {mojo_err:.3e}")
    # an f32 sum over 1M rows errs by up to ~eps·sqrt(N) ≈ 6e-5 relative;
    # TF32 rounds every operand to 10 bits, ~5e-4 a product
    if gram_err > 1e-4:
        bad.append(f"the Gram is {gram_err:.2e} (relative) from f64: TF32?")
    if any(counts.values()):
        bad.append(f"the GLM fit launched a tree kernel: {counts}")
    if bad:
        raise AssertionError("; ".join(bad))
    tf32_off()
    return rec


def _valid_deviance(model, fv):
    """A binomial model's deviance on `fv` rescored on the host in f64:
    2 · rows · logloss."""
    return 2.0 * fv.nrow * float(model.model_performance(fv).logloss)


def airlines_lambda_path(dev, fr, fv):
    """Phase 18: λ search with a validation frame at full width; returns
    its record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from h2o3_tpu_torch import convert
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    tf32_off()
    params = dict(family="binomial", alpha=0.5, lambda_search=True,
                  device=str(dev))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = H2OGeneralizedLinearEstimator(**params)
    est.train(y="IsDepDelayed", training_frame=fr, validation_frame=fv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    m = est.model
    plan = m.fitplan
    devs = plan["path_deviances"]
    best = plan["best_index"]
    # the chosen λ's f32 path β and the host's f64 re-solve, both rescored
    di = m.dinfo
    path_model = convert.glm_from_numpy(
        beta=m.full_path[best][1], family="binomial", x=m.x, y=m.y,
        spec=di._spec, coef_names=di.coef_names, means=di.means,
        stds=di.stds, col_means=di.col_means,
        transfer_groups=di._transfer_groups, domain=m.domain, device=dev)
    dev_path = _valid_deviance(path_model, fv)
    dev_resolved = _valid_deviance(m, fv)
    # the same fit under torch.profiler (device activity only): launches
    # and device time; the busy share is over the unprofiled wall
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        H2OGeneralizedLinearEstimator(**params).train(
            y="IsDepDelayed", training_frame=fr, validation_frame=fv)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t1
    # the raw device activity records (no FunctionEvent tree: a path's
    # ~250,000 records would take minutes to build one)
    dev_events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
    kernels = [e for e in dev_events
               if not e.name().startswith(("Memcpy", "Memset"))]
    busy_s = sum(e.duration_ns() for e in dev_events) / 1e9
    top = Counter(e.name()[:60] for e in kernels).most_common(6)
    rec = dict(rows=fr.nrow, valid_rows=fv.nrow, path=plan["path"],
               nlambda=len(m.full_path), lambda_best=m.lambda_best,
               best_index=best, path_deviances=devs,
               irls_iterations=plan["irls_iterations"],
               ista_steps=plan["ista_steps"], wall_s=wall,
               timings=m.fit_timings, kernel_launches=len(kernels),
               device_events=len(dev_events), device_busy_s=busy_s,
               busy_share=busy_s / wall, profiled_wall_s=prof_wall,
               valid_deviance_path=dev_path,
               valid_deviance_resolved=dev_resolved,
               top_kernels=top, kernel_counts=counts)
    print("glm lambda path: " + json.dumps(rec), flush=True)
    print(f"glm lambda path on {card_line()}: {len(m.full_path)} λ, best "
          f"#{best} λ={m.lambda_best:.6g}, {plan['irls_iterations']} IRLS "
          f"iterations, {plan['ista_steps']} ISTA steps, "
          f"{len(kernels)} kernel launches; fit {wall:.3f} s, device busy "
          f"{busy_s:.3f} s ({100 * busy_s / wall:.2f} %); validation "
          f"deviance at λ_best: path {dev_path:.6f}, re-solved "
          f"{dev_resolved:.6f}", flush=True)
    bad = []
    if plan["path"] != "fused_path" or len(m.full_path) != AIR_NLAMBDA:
        bad.append(f"path {plan['path']} with {len(m.full_path)} λ")
    if int(np.argmin(devs)) != best or m.lambda_best != m.full_path[best][0]:
        bad.append(f"λ_best #{best} is not the argmin of the validation "
                   "deviances")
    # the re-solve (f64, ISTA to 1e-9) may not score worse than the f32
    # path's β beyond 1e-6 relative: the two solve the same problem to
    # β_eps, and a gap that small is below the f32 rescoring's resolution
    if not (np.isfinite(dev_resolved)
            and dev_resolved <= dev_path * (1 + 1e-6)):
        bad.append(f"re-solved deviance {dev_resolved} above the path's "
                   f"{dev_path}")
    if any(counts.values()):
        bad.append(f"the λ path launched a tree kernel: {counts}")
    if bad:
        raise AssertionError("; ".join(bad))
    tf32_off()
    return rec


def glm_small_frame(n: int, seed: int, family: str, weights: bool = False):
    """tests/test_torch_glm.py::glm_frame: two numeric columns (one with
    3 % NaN) and three string enums of 4, 3 and 5 levels, the response
    drawn from `family` around a linear predictor in all five."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = rng.uniform(0, 4, n)
    c1 = rng.integers(0, 4, n)
    c2 = rng.integers(0, 3, n)
    c3 = rng.integers(0, 5, n)
    eta = (0.8 * np.nan_to_num(a) - 0.3 * b + np.asarray([0, .5, -.4, .2])[c1]
           + np.asarray([0, -.6, .3])[c2] + 0.15 * c3)
    if family == "gaussian":
        y = 1.0 + eta + 0.5 * rng.normal(size=n)
    elif family == "binomial":
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "yes",
                     "no").astype(object)
    elif family == "poisson":
        y = rng.poisson(np.exp(0.5 * eta)).astype(np.float64)
    elif family == "gamma":
        y = rng.gamma(2.0, np.exp(0.5 * eta + 1.0) / 2.0)
    else:  # tweedie: a compound Poisson-gamma with exact zeros
        y = rng.poisson(np.exp(0.5 * eta)) * rng.gamma(2.0, 0.5, n)
    a = a.copy()
    a[rng.random(n) < 0.03] = np.nan
    d = {"a": a, "b": b,
         "c1": np.asarray(["ORD", "JFK", "SFO", "ATL"], dtype=object)[c1],
         "c2": np.asarray(["mon", "tue", "wed"], dtype=object)[c2],
         "c3": np.asarray([f"L{i}" for i in range(5)], dtype=object)[c3],
         "y": y}
    if weights:
        d["w"] = rng.uniform(0.5, 2.0, n)
    types = {"c1": "enum", "c2": "enum", "c3": "enum"}
    if family == "binomial":
        types["y"] = "enum"
    return Frame.from_dict(d, column_types=types)


GLM_SMALL_CASES = {
    "gaussian_ols": ("gaussian", dict(lambda_=0.0)),
    "binomial": ("binomial", dict(lambda_=0.0)),
    "poisson": ("poisson", dict(lambda_=0.0)),
    "gamma": ("gamma", dict(lambda_=0.0)),
    "tweedie": ("tweedie", dict(lambda_=0.0)),
    "ridge": ("gaussian", dict(lambda_=0.05, alpha=0.0)),
    "lasso": ("gaussian", dict(lambda_=0.02, alpha=1.0)),
    "non_negative": ("gaussian", dict(lambda_=0.0, non_negative=True)),
    "weighted_binomial": ("binomial", dict(lambda_=0.0, weights_column="w")),
    "lambda_search_valid": ("binomial", dict(lambda_search=True, alpha=0.5,
                                             nlambdas=10)),
    "pvalues_gamma": ("gamma", dict(lambda_=0.0, compute_p_values=True)),
}


def small_glm_checks(dev):
    """Phase 19: GLM on small frames (4000 x 5), card against CPU (whose
    plain path the CPU tests hold against the JAX package): the same path,
    IRLS iterations and λ chosen; β within 1e-4 and predictions within
    1e-5 (relative to max(1, |p|) for the log links): the card's cuBLAS
    Gram adds its f32 sums in another order than the CPU's, so β differs in
    its last bits (~1e-6 on these frames), as between the CPU and the JAX
    package. Standard errors within 1e-4 relative. Then the binomial GLM
    served by `ScoringEngine` on the card from 4 threads. Every case is
    fitted and printed before the first failure is raised."""
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    tf32_off()
    x = ["a", "b", "c1", "c2", "c3"]
    out, bad, models = {}, [], {}
    for name, (family, params) in GLM_SMALL_CASES.items():
        weights = "weights_column" in params
        fr = glm_small_frame(4000, 0, family, weights=weights)
        fv = glm_small_frame(1500, 1, family, weights=weights)
        valid = fv if params.get("lambda_search") else None
        fits = []
        for d in (str(dev), "cpu"):
            e = H2OGeneralizedLinearEstimator(family=family, device=d,
                                              **params)
            e.train(x=x, y="y", training_frame=fr, validation_frame=valid)
            fits.append(e.model)
        a, b = fits
        pa, pb = a.predict(fv), b.predict(fv)
        cols = pa.names[1:] if family == "binomial" else pa.names
        scale = 1.0
        if family in ("poisson", "gamma", "tweedie"):
            scale = max(1.0, float(np.abs(np.asarray(
                pb.vec("predict").data)).max()))
        dp = max(float(np.abs(np.asarray(pa.vec(c).data, np.float64)
                              - np.asarray(pb.vec(c).data, np.float64)).max())
                 for c in cols)
        db = float(np.abs(np.asarray(a.beta) - np.asarray(b.beta)).max())
        dse = (float(np.max(np.abs(a.stderr - b.stderr) / b.stderr))
               if b.stderr is not None else 0.0)
        keys = ("path", "iterations", "best_index")
        rec = dict(plans=[{k: f.fitplan.get(k) for k in keys}
                          for f in fits],
                   lambda_best=[a.lambda_best, b.lambda_best],
                   max_beta_diff=db, max_predict_diff=dp,
                   predict_scale=scale, max_stderr_rel_diff=dse)
        out[name] = rec
        print(f"glm small check {name}: " + json.dumps(rec), flush=True)
        if rec["plans"][0] != rec["plans"][1] or \
                a.fitplan["path"] not in ("fused", "fused_path"):
            bad.append(f"{name}: cuda and cpu fits ran other paths or "
                       "iterations")
        if abs(a.lambda_best - b.lambda_best) > 1e-5 * max(b.lambda_best,
                                                          1e-300):
            bad.append(f"{name}: λ_best {a.lambda_best} vs {b.lambda_best}")
        if db > 1e-4 or dp > 1e-5 * scale or dse > 1e-4:
            bad.append(f"{name}: cuda and cpu fits disagree beyond the "
                       "tolerance")
        models[name] = a
    # the binomial GLM served on the card
    model = models["binomial"]
    rng = np.random.default_rng(51)
    reqs = []
    for i, n in enumerate(rng.integers(1, 301, 24)):
        fr = glm_small_frame(int(n), 100 + i, "binomial")
        reqs.append(fr[[c for c in fr.names if c != "y"]])
    engine = ScoringEngine(ServingConfig())
    zero_counts()
    with ThreadPoolExecutor(max_workers=4) as ex:
        served = list(ex.map(lambda r: engine.score("glm", model, r), reqs))
    snap = engine.snapshot()
    engine.shutdown()
    worst = max(float(np.abs(np.asarray(o.vec("yes").data, np.float64)
                             - np.asarray(model.predict(r).vec("yes").data,
                                          np.float64)).max())
                for r, o in zip(reqs, served))
    tot, fo = snap["totals"], snap["failover"]
    print(f"glm serving: {len(reqs)} requests in {tot['batches']} batches, "
          f"max |served - predict| {worst:.3e}, fallback scores "
          f"{tot['fallback_scores']}, errors {tot['errors']}", flush=True)
    if worst > 1e-6 or tot["fallback_scores"] or fo["fallback_builds"] \
            or tot["errors"] or snap["cache"]["misses"] != 1:
        bad.append("serving the GLM: " + json.dumps(dict(
            worst=worst, totals=tot, failover=fo)))
    if bad:
        raise AssertionError("; ".join(bad))
    tf32_off()
    return out


# phases 20-23: the explanation outputs. The H100 SXM data sheet's FP64
# peak outside the tensor cores, 34 TFLOP/s, counts an FMA as two
# operations; TreeSHAP's adds, multiplies and divides are unfused scalar
# FP64 instructions (`__d*_rn`), which issue at half that rate
FP64_OPS_PER_S = 17e12
SHAP_ROWS = 100_000
# the DRF's 10,000 explained rows, cut from 100,000: path-dependent
# TreeSHAP on its 50 trees of depth 19 costs ~10^9 FP64 operations a row,
# ≈0.9 ms a row of kernel time on an H100 (PERF.md §5), and phase 20 runs
# the DRF's rows through the kernel three times
SHAP_DRF_ROWS, SHAP_DRF_CUT_FROM = 10_000, 100_000
# the DRF's first rows also timed alone: the size at which the kernel's
# earlier design was measured (PERF.md §6), and one at which a tree's warps
# set the call's time
SHAP_DRF_SHORT_ROWS = 1_000
SHAP_PLAIN_ROWS = 512
# the DRF's rows that its slice of one depth-19 tree explains, kernel
# against plain on the CPU (~1.5 ms of host time a leaf, ~22,600 leaves)
SHAP_SLICE_ROWS = 32
# phase 21's rows per forest; phase 22's requests, as phase 12's
LEAF_ROWS = 100_000
MOJO_SHAP_ROWS = 1_000


def shap_ops(forest, depth: int, n_feat: int) -> int:
    """FP64 adds, multiplies and divides of one row's TreeSHAP over a
    stacked forest, as csrc/tree_shap.cu does them, counted from the
    forest's own paths level by level on the device. Every row visits
    every reachable node and unwinds at the same places; entering a node
    whose path holds L features costs 7L (EXTEND) and, below the root, 2
    (its zero fraction); a split node whose feature is already on the path
    unwinds L elements; a leaf costs 1 + L(4L + 4) (an unwound sum of L
    steps and 4 operations for each of its L features). Where a row's one
    fraction picks the arithmetic of a step (UNWIND and the unwound sums),
    the cheaper branch is counted (3 and 4 operations a step against 7 and
    8), so the count is a lower bound and the same for every row; a
    divide counts as one operation, though DDIV is a sequence of several
    instructions. The fold adds ntrees per feature. Feature sets are int64 bit masks
    (F <= 62)."""
    nt = int(forest.feat.shape[0])
    if n_feat > 62:
        raise ValueError("shap_ops keeps feature sets in int64 masks")
    dev = forest.feat.device
    live = torch.ones((nt, 1), dtype=torch.bool, device=dev)
    lenb = torch.zeros((nt, 1), dtype=torch.int64, device=dev)
    mask = torch.zeros((nt, 1), dtype=torch.int64, device=dev)
    total = 0
    for lvl in range(depth + 1):
        lo, n = 2 ** lvl - 1, 2 ** lvl
        split = (forest.is_split[:, lo:lo + n] & live if lvl < depth
                 else torch.zeros_like(live))
        leaf = live & ~split
        L = lenb
        total += int(((7 * L + (2 if lvl else 0)) * live).sum())
        total += int(((1 + L * (4 * L + 4)) * leaf).sum())
        f = forest.feat[:, lo:lo + n].to(torch.int64).clamp(0, n_feat - 1)
        rep = ((mask >> f) & 1).bool()
        total += int((3 * L * (split & rep)).sum())
        if lvl < depth:
            live = split.repeat_interleave(2, dim=1)
            lenb = (L + (~rep).to(torch.int64)).repeat_interleave(2, dim=1)
            mask = (mask | (1 << f)).repeat_interleave(2, dim=1)
    return total + n_feat * nt


def replay_ops(forest, depth: int, n_feat: int) -> int:
    """FP64 adds, multiplies and divides of one row's TreeSHAP as the
    replay kernel does them: `shap_ops`'s counting rule with each leaf's
    root path rebuilt from the root. A leaf costs 1 + L(4L + 4) plus, for
    every node on its root path, 7L to EXTEND into it and 3L where its
    parent's split UNWINDs a repeated feature; the zero fractions come
    from the plan, so their 2 operations a node are not counted. The fold
    adds ntrees per feature."""
    nt = int(forest.feat.shape[0])
    if n_feat > 62:
        raise ValueError("replay_ops keeps feature sets in int64 masks")
    dev = forest.feat.device
    live = torch.ones((nt, 1), dtype=torch.bool, device=dev)
    lenb = torch.zeros((nt, 1), dtype=torch.int64, device=dev)
    mask = torch.zeros((nt, 1), dtype=torch.int64, device=dev)
    pre = torch.zeros((nt, 1), dtype=torch.int64, device=dev)
    total = 0
    for lvl in range(depth + 1):
        lo, n = 2 ** lvl - 1, 2 ** lvl
        split = (forest.is_split[:, lo:lo + n] & live if lvl < depth
                 else torch.zeros_like(live))
        leaf = live & ~split
        L = lenb
        cum = pre + 7 * L
        total += int(((cum + 1 + L * (4 * L + 4)) * leaf).sum())
        f = forest.feat[:, lo:lo + n].to(torch.int64).clamp(0, n_feat - 1)
        rep = ((mask >> f) & 1).bool()
        if lvl < depth:
            live = split.repeat_interleave(2, dim=1)
            pre = (cum + 3 * L * (split & rep)).repeat_interleave(2, dim=1)
            lenb = (L + (~rep).to(torch.int64)).repeat_interleave(2, dim=1)
            mask = (mask | (1 << f)).repeat_interleave(2, dim=1)
    return total + n_feat * nt


def shap_ptxas(log: str) -> dict:
    """{depth bucket: registers, stack and spill bytes} of the replay
    kernel's instances, from the `-Xptxas -v` report of its build."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"tree_shap_replayILi(\d+)E", line)
        if m:
            cur = out.setdefault(int(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return dict(sorted(out.items()))


def shap_bound_ms(forest, depth, n_feat, n):
    """(least time of one TreeSHAP call on the card in ms, its bound, FP64
    operations, bytes): the operations of `shap_ops` over FP64_OPS_PER_S,
    and the bytes (X and the output once, 17 bytes of fields of every
    reachable node) over the memory rate; the larger."""
    ops = shap_ops(forest, depth, n_feat) * n
    above, _, leaves = walk_nodes(forest, depth)
    nbytes = (above + leaves) * 17 + n * (2 * n_feat + 1) * 8
    t_ops, t_bytes = ops / FP64_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def _contrib_matrix(fr):
    return np.column_stack([np.asarray(fr.vec(n).data, np.float64)
                            for n in fr.names])


def _cpu_forest(forest):
    from h2o3_tpu_torch.models.tree import Tree

    return Tree(*[f.cpu() for f in forest])


def _shap_small_drf(dev):
    """A small DRF (4000 x 8, depth 10, 5 trees) fitted on the card, as
    phase 9's; returns the model."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=[f"f{i}" for i in range(8)] + ["label"]
                          ).asfactor("label")
    est = H2ORandomForestEstimator(ntrees=5, max_depth=10, seed=42,
                                   hist_method="pallas", device=str(dev))
    est.train(y="label", training_frame=fr)
    return est.model


def contributions_path(dev, gbm_model, drf_model):
    """Phase 20: `predict_contributions` at full width: phase 4's GBM on
    SHAP_ROWS fresh rows, phase 8's DRF on SHAP_DRF_ROWS (cut from
    SHAP_DRF_CUT_FROM). The counts are zeroed just before and read just
    after; then the DRF once more (its bias term kept by the model), the
    bias term timed, and the kernel against its plain version, bit for
    bit, on all the GBM's rows, on SHAP_PLAIN_ROWS of them, on one of the
    DRF's depth-19 trees and on a small DRF, and timed. Returns (record,
    the JSON line's entry)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import tree_shap as ts
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(51)
    names = [f"f{i}" for i in range(N_FEAT)]
    Xg = score_rows(rng, SHAP_ROWS)
    Xr = score_rows(rng, SHAP_DRF_ROWS)
    fg = Frame.from_numpy(Xg, names=names)
    fd = Frame.from_numpy(Xr, names=names)
    print(f"phase 20 cut: the DRF explains {SHAP_DRF_ROWS} rows, reduced "
          f"from {SHAP_DRF_CUT_FROM}", flush=True)
    for model in (gbm_model, drf_model):
        model.__dict__.pop("_shap_plan_of", None)
    zero_counts()
    shap_cuda.scratch_peak = 0
    builds = ts.plan_builds
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg = gbm_model.predict_contributions(fg)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    cd = drf_model.predict_contributions(fd)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    launches = shap_cuda.launches
    other = kernel_counts()
    scratch = shap_cuda.scratch_peak
    peak = torch.cuda.max_memory_allocated(dev)
    bad = []
    # one launch per chunk of rows
    expect = sum(-(-n // shap_cuda.chunk_rows(n, m.ntrees_built, N_FEAT))
                 for n, m in ((SHAP_ROWS, gbm_model),
                              (SHAP_DRF_ROWS, drf_model)))
    if launches != expect:
        bad.append(f"predict_contributions launched the TreeSHAP kernel "
                   f"{launches} times, expected {expect}")
    if other["hist"] or other["hist_rows"] or other["score"]:
        bad.append(f"contributions launched other kernels: {other}")
    # each model built its path plan at its first call and keeps it
    plans = {name: model._shap_plan_of[2] for name, model in
             (("gbm", gbm_model), ("drf", drf_model))}
    built = ts.plan_builds - builds
    # the DRF again: the model kept its bias term and its plan
    t0 = time.perf_counter()
    drf_model.predict_contributions(fd)
    torch.cuda.synchronize()
    wall_d2 = time.perf_counter() - t0
    if built != 2 or ts.plan_builds - builds != 2 \
            or drf_model._shap_plan(N_FEAT) is not plans["drf"]:
        bad.append(f"path plans built: {built} at the first calls (expected "
                   f"2), {ts.plan_builds - builds - built} at the second")
    rec = dict(gbm_rows=SHAP_ROWS, drf_rows=SHAP_DRF_ROWS, launches=launches,
               gbm_wall_s=wall_g, drf_wall_s=wall_d,
               drf_wall_kept_s=wall_d2, scratch_peak_bytes=scratch,
               peak_device_bytes=peak,
               ptxas=shap_ptxas(shap_cuda.build_log))
    # the path plan's build where the forest lies, timed on its own
    for name, model in (("gbm", gbm_model), ("drf", drf_model)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = ts.build_shap_plan(model.forest[0], model.covers[0], N_FEAT)
        torch.cuda.synchronize()
        rec[f"{name}_plan"] = dict(
            build_ms=(time.perf_counter() - t0) * 1e3, bytes=plan.nbytes(),
            leaves=int(plan.leaf_level.numel()),
            steps=int(plan.step_zin.numel()))
        if any(not torch.equal(a, b) for a, b in zip(plan, plans[name])
               if isinstance(a, torch.Tensor)):
            bad.append(f"{name}: a second plan build differs from the kept")
    # the bias term where the forest lies (as the model computes it) and
    # through a copy of is_split, value and cover to the host
    for name, model in (("gbm", gbm_model), ("drf", drf_model)):
        forest, cover = model.forest[0], model.covers[0]
        scale = 1.0 / model.ntrees_built if model.mode == "drf" else 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = ts.forest_bias(forest, cover, scale)
        t1 = time.perf_counter()
        on_host = ts.forest_bias(_cpu_forest(forest), cover.cpu(), scale)
        t2 = time.perf_counter()
        rec[f"{name}_bias_ms"] = dict(on_card=(t1 - t0) * 1e3,
                                      copied_to_host=(t2 - t1) * 1e3)
        kept = model._shap_bias(scale)
        if not on_card == on_host == kept:
            bad.append(f"{name}: the bias term differs on the card "
                       f"({on_card!r}), on the host ({on_host!r}) and as "
                       f"kept ({kept!r})")
    # local accuracy and a constant bias term
    for name, model, fr, C in (("gbm", gbm_model, fg, cg),
                               ("drf", drf_model, fd, cd)):
        M = _contrib_matrix(C)
        marg = model._margins(model._matrix(fr))[:, 0]
        if model.mode == "drf":
            marg = marg / model.ntrees_built
        err = np.abs(M.sum(axis=1) - marg) / np.maximum(1.0, np.abs(marg))
        rec[f"{name}_local_accuracy_rel_err"] = float(err.max())
        if C.names != names + ["BiasTerm"] or not np.all(np.isfinite(M)):
            bad.append(f"{name} contributions: {C.names[:3]}..., finite "
                       f"{bool(np.all(np.isfinite(M)))}")
        if not err.max() <= 1e-5:
            bad.append(f"{name}: sum of contributions misses the margin by "
                       f"{err.max():.3e} (relative)")
        if not np.all(M[:, -1] == M[0, -1]):
            bad.append(f"{name}: BiasTerm varies over rows")
    # the kernel against its plain version on the same inputs
    worst = 0.0
    split_counts = drf_model.forest[0].is_split.sum(dim=1)
    drf_tree = int(split_counts.argmin())
    cases = [("gbm", gbm_model, Xg[:SHAP_PLAIN_ROWS], None),
             ("small_drf", _shap_small_drf(dev), None, None),
             ("drf_tree", drf_model, Xr[:SHAP_SLICE_ROWS], drf_tree)]
    for name, model, X, tree in cases:
        if X is None:
            X = np.asarray(make_higgs_like(1000, n_feat=8, seed=9)[0])
            X[rng.random(X.shape) < 0.05] = np.nan
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float64)).to(dev)
        forest, cover = model.forest[0], model.covers[0]
        scale = 1.0 / model.ntrees_built if model.mode == "drf" else 1.0
        if tree is not None:
            # one depth-19 tree: the kernel's depth-20 instance; the plain
            # version on the CPU only (on the card it is slower still)
            forest = type(forest)(*[f[tree:tree + 1].contiguous()
                                    for f in forest])
            cover = cover[tree:tree + 1].contiguous()
        bias = ts.forest_bias(forest, cover, scale)
        got = shap_cuda.tree_shap(forest, cover, Xd, scale, bias)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = (ts.tree_shap_plain(forest, cover, Xd, scale, bias)
                if tree is None else None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = ts.tree_shap_plain(_cpu_forest(forest), cover.cpu(), Xd.cpu(),
                                  scale, bias)
        t2 = time.perf_counter()
        same = torch.equal(got.cpu(), host) and (
            want is None or torch.equal(got, want))
        err = float((got.cpu() - host).abs().max())
        worst = max(worst, err)
        rec[f"{name}_equal_to_plain"] = same
        rec[f"{name}_plain_ms_{X.shape[0]}_rows"] = dict(
            card=None if want is None else (t1 - t0) * 1e3,
            cpu=(t2 - t1) * 1e3)
        what = (f"tree {tree} of the DRF, {int(split_counts[tree])} splits, "
                f"depth {model.max_depth}" if tree is not None else
                f"{model.ntrees_built} trees, depth {model.max_depth}")
        print(f"tree_shap {name} ({what}) on {X.shape[0]} rows: kernel equal "
              f"to the plain version bit for bit: {same} ("
              + ("on the CPU" if want is None else "on the card and on the "
                 f"CPU; plain {(t1 - t0) * 1e3:.1f} ms on the card")
              + f"; plain {(t2 - t1) * 1e3:.1f} ms on the CPU)", flush=True)
        if not same:
            bad.append(f"TreeSHAP kernel differs from its plain version on "
                       f"{name}: max |err| {err:.3e}")
    # times at the main path's shapes (and on the DRF's first
    # SHAP_DRF_SHORT_ROWS rows): the kernel by CUDA events with
    # the kept plan, the plain version once on the GBM's full rows
    shapes, last = {}, {}
    for name, model, X, reps in (
            ("gbm", gbm_model, Xg, 5), ("drf", drf_model, Xr, 1),
            (f"drf_{SHAP_DRF_SHORT_ROWS}", drf_model,
             Xr[:SHAP_DRF_SHORT_ROWS], 1)):
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float64)).to(dev)
        forest, cover = model.forest[0], model.covers[0]
        scale = 1.0 / model.ntrees_built if model.mode == "drf" else 1.0
        bias = ts.forest_bias(forest, cover, scale)
        plan = plans[name.split("_")[0]]

        def run():
            last[name] = shap_cuda.tree_shap(forest, cover, Xd, scale, bias,
                                             plan=plan)

        ms = time_ms(run, reps=reps, warmup=1 if reps > 1 else 0)
        bound, by, ops, nbytes = shap_bound_ms(forest, model.max_depth,
                                               N_FEAT, X.shape[0])
        shapes[name] = dict(rows=X.shape[0], trees=model.ntrees_built,
                            depth=model.max_depth, ms=ms, bound_ms=bound,
                            bound_by=by, fp64_ops=ops, bytes=nbytes,
                            ops_per_row=ops // X.shape[0],
                            replay_ops_per_row=replay_ops(
                                forest, model.max_depth, N_FEAT))
    Xd = torch.from_numpy(np.ascontiguousarray(Xg, np.float64)).to(dev)
    forest, cover = gbm_model.forest[0], gbm_model.covers[0]
    bias = ts.forest_bias(forest, cover, 1.0)

    def run_plain():
        last["gbm_plain"] = ts.tree_shap_plain(forest, cover, Xd, 1.0, bias)

    plain_ms = time_ms(run_plain, reps=1, warmup=0)
    shapes["gbm"]["plain_ms"] = plain_ms
    # the kernel's last timed output on all the GBM's rows (2 chunks)
    same = torch.equal(last["gbm"], last["gbm_plain"])
    rec[f"gbm_{SHAP_ROWS}_rows_equal_to_plain"] = same
    worst = max(worst, float((last["gbm"] - last["gbm_plain"]).abs().max()))
    print(f"tree_shap gbm on all {SHAP_ROWS} rows: kernel equal to the plain "
          f"version on the card bit for bit: {same}", flush=True)
    if not same:
        bad.append(f"TreeSHAP kernel differs from its plain version on the "
                   f"GBM's {SHAP_ROWS} rows")
    rec["shapes"] = shapes
    print("contributions: " + json.dumps(rec), flush=True)
    print("tree_shap.cu -Xptxas -v, replay kernel by depth bucket: "
          + "; ".join(f"{d}: {r.get('registers')} registers, "
                      f"{r.get('stack')} B stack, {r.get('spill_stores')} / "
                      f"{r.get('spill_loads')} B spill stores / loads"
                      for d, r in rec["ptxas"].items()), flush=True)
    for name, s in shapes.items():
        p = rec[f"{name.split('_')[0]}_plan"]
        wall = rec.get(f"{name}_wall_s")
        print(f"tree_shap {name} on {card_line()}: {s['rows']} rows x "
              f"{s['trees']} trees of depth {s['depth']}: kernel "
              f"{s['ms']:.3f} ms (CUDA events, plan prebuilt), FP64 bound "
              f"{s['bound_ms']:.3f} ms ({s['ops_per_row']} operations a row "
              f"by shap_ops, {s['bound_by']}; the replay does "
              f"{s['replay_ops_per_row']}, "
              f"{s['replay_ops_per_row'] / max(s['ops_per_row'], 1):.3f}x), "
              + (f"plain {s['plain_ms']:.1f} ms; " if "plain_ms" in s else "")
              + (f"predict_contributions wall {wall * 1e3:.1f} ms; "
                 if wall is not None else "")
              + f"path plan "
              f"{p['bytes']} B ({p['leaves']} leaves, {p['steps']} steps), "
              f"built in {p['build_ms']:.2f} ms", flush=True)
    print(f"predict_contributions of the DRF again, its bias term and plan "
          f"kept: wall {wall_d2 * 1e3:.1f} ms; the bias term where the "
          f"forest lies "
          f"/ through a copy to the host: gbm "
          f"{rec['gbm_bias_ms']['on_card']:.2f} / "
          f"{rec['gbm_bias_ms']['copied_to_host']:.2f} ms, drf "
          f"{rec['drf_bias_ms']['on_card']:.2f} / "
          f"{rec['drf_bias_ms']['copied_to_host']:.2f} ms", flush=True)
    print(f"tree_shap scratch peak {scratch / 1e6:.1f} MB, device memory "
          f"peak {peak / 1e9:.2f} GB, {launches} launches", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    entry = dict(
        name="tree_shap", route="cuda",
        source="h2o3_tpu_torch/csrc/tree_shap.cu",
        replaces="h2o3_tpu/native/tree_shap.cpp:123", launches=launches,
        max_abs_err=worst, ms=shapes["gbm"]["ms"], plain_ms=plain_ms,
        bound_ms=shapes["gbm"]["bound_ms"], bound_by=shapes["gbm"]["bound_by"],
        library_ms=None)
    return rec, entry


def _decode_paths(labels):
    """Heap node ids of "L"/"R" root paths."""
    u, inv = np.unique(labels, return_inverse=True)
    ids = []
    for p in u:
        node = 0
        for step in p:
            node = 2 * node + (1 if step == "L" else 2)
        ids.append(node)
    return np.asarray(ids, np.int64)[inv.reshape(-1)]


def leaves_path(dev, gbm_model, drf_model):
    """Phase 21: leaf assignment in both types, feature frequencies and
    (GBM) staged probabilities on LEAF_ROWS fresh rows of both forests."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.tree import forest_leaves

    rng = np.random.default_rng(61)
    names = [f"f{i}" for i in range(N_FEAT)]
    fr = Frame.from_numpy(score_rows(rng, LEAF_ROWS), names=names)
    rec, bad = {}, []
    for name, model in (("gbm", gbm_model), ("drf", drf_model)):
        times = {}
        t0 = time.perf_counter()
        ids = model.predict_leaf_node_assignment(fr, type="Node_ID")
        times["node_id_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths = model.predict_leaf_node_assignment(fr, type="Path")
        times["path_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        freq = model.feature_frequencies(fr)
        times["frequencies_s"] = time.perf_counter() - t0
        X = torch.from_numpy(model._matrix(fr))
        want = forest_leaves(_cpu_forest(model.forest[0]), X,
                             model.max_depth).numpy()
        got = np.column_stack([np.asarray(ids.vec(c).data) for c in ids.names]).T
        if not np.array_equal(got, want.astype(np.float64)):
            bad.append(f"{name}: Node_ID differs from the CPU's forest_leaves")
        for j, c in enumerate(paths.names):
            v = paths.vec(c)
            lab = np.asarray(v.domain, dtype=object)[np.asarray(v.data)]
            if not np.array_equal(_decode_paths(lab), want[j]):
                bad.append(f"{name}: Path {c} does not decode to Node_ID")
                break
        depth_of = np.floor(np.log2(want + 1.0)).sum(axis=0)
        F = np.column_stack([np.asarray(freq.vec(c).data) for c in freq.names])
        if not np.array_equal(F.sum(axis=1), depth_of):
            bad.append(f"{name}: feature frequencies do not sum to the "
                       "splits on each row's paths")
        if name == "gbm":
            t0 = time.perf_counter()
            staged = model.staged_predict_proba(fr)
            times["staged_s"] = time.perf_counter() - t0
            p1 = np.asarray(model.predict(fr).vec("1").data, np.float64)
            last = np.asarray(staged.vec(staged.names[-1]).data, np.float64)
            times["staged_last_vs_predict"] = float(np.abs(last - p1).max())
            if len(staged.names) != model.ntrees_built or \
                    not times["staged_last_vs_predict"] <= 1e-6:
                bad.append("staged_predict_proba's last column is not "
                           "predict's p1 within 1e-6")
        rec[name] = times
        print(f"leaves {name} ({model.ntrees_built} trees, {LEAF_ROWS} rows) "
              f"on {card_line()}: " + json.dumps(times), flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def serve_explanations(dev, model):
    """Phase 22: "contributions" and "leaves" served by `ScoringEngine`
    from SERVE_THREADS threads, SERVE_REQUESTS requests of
    1..SERVE_MAX_ROWS rows each, at phase 12's `ServingConfig`; then the
    MOJO scorer's contributions against the card's."""
    import h2o3_tpu_torch.mojo as mojo
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.ops import shap_cuda
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    rng = np.random.default_rng(71)
    names = [f"f{i}" for i in range(N_FEAT)]
    reqs = [Frame.from_numpy(score_rows(rng, int(n)), names=names)
            for n in rng.integers(1, SERVE_MAX_ROWS + 1, SERVE_REQUESTS)]
    methods = dict(contributions="predict_contributions",
                   leaves="predict_leaf_node_assignment")
    rec, bad = {}, []
    for kind, method in methods.items():
        engine = ScoringEngine(ServingConfig())

        def call(fr):
            t0 = time.perf_counter()
            out = engine.score("gbm", model, fr, output_kind=kind)
            return out, time.perf_counter() - t0

        shap_cuda.launches = 0
        torch.cuda.synchronize()
        with ThreadPoolExecutor(max_workers=SERVE_THREADS) as ex:
            results = list(ex.map(call, reqs))
        launches = shap_cuda.launches
        snap = engine.snapshot()
        engine.shutdown()
        for fr, (out, _) in zip(reqs, results):
            want = getattr(model, method)(fr)
            same = out.names == want.names and out.nrow == fr.nrow
            for c in want.names if same else []:
                a, b = out.vec(c), want.vec(c)
                if a.type == "enum":
                    same &= np.array_equal(
                        np.asarray(a.domain, dtype=object)[np.asarray(a.data)],
                        np.asarray(b.domain, dtype=object)[np.asarray(b.data)])
                else:
                    same &= np.array_equal(np.asarray(a.data),
                                           np.asarray(b.data))
            if not same:
                bad.append(f"served {kind} differ from model.{method}")
                break
        lat = np.array([s for _, s in results]) * 1e3
        tot, fo = snap["totals"], snap["failover"]
        r = dict(requests=len(reqs), p50_ms=float(np.percentile(lat, 50)),
                 p99_ms=float(np.percentile(lat, 99)),
                 batches=tot["batches"], fallback_scores=tot["fallback_scores"],
                 fallback_builds=fo["fallback_builds"], errors=tot["errors"],
                 tree_shap_launches=launches)
        rec[kind] = r
        print(f"serving {kind} on {card_line()}: " + json.dumps(r), flush=True)
        if tot["fallback_scores"] or fo["fallback_builds"] or tot["errors"] \
                or fo["breakers"]:
            bad.append(f"serving {kind} degraded: " + json.dumps(
                dict(failover=fo, totals=tot)))
        if kind == "contributions" and launches < tot["batches"]:
            bad.append(f"{tot['batches']} contributions batches launched the "
                       f"TreeSHAP kernel {launches} times")
    fr = Frame.from_numpy(score_rows(rng, MOJO_SHAP_ROWS), names=names)
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_shap_") as d:
        scorer = mojo.load_model(mojo.save_model(model, d, "gbm.h2o3"))
        t0 = time.perf_counter()
        host = _contrib_matrix(scorer.predict_contributions(fr))
        mojo_s = time.perf_counter() - t0
    card = _contrib_matrix(model.predict_contributions(fr))
    err = float(np.abs(host - card).max())
    rec["mojo"] = dict(rows=MOJO_SHAP_ROWS, max_abs_err=err, host_s=mojo_s)
    print(f"mojo contributions on {MOJO_SHAP_ROWS} rows: host plain TreeSHAP "
          f"{mojo_s:.2f} s, max |err| vs the card {err:.3e}", flush=True)
    if not err <= 1e-10:
        bad.append(f"MOJO contributions {err:.3e} away from the card's")
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def small_explain_checks(dev):
    """Phase 23: small fits, card against CPU: a GBM with `offset_column`
    (bernoulli and gaussian, each with a validation frame carrying its own
    offset) gives the same forest structure and predictions within 1e-5;
    the contributions of a small GBM and DRF fitted on the card equal the
    CPU's plain version on the same forests within 1e-10."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import tree_shap as ts

    rng = np.random.default_rng(81)
    names = [f"f{i}" for i in range(8)] + ["off", "label"]
    out, bad = {}, []

    def frame(n, dist):
        X = rng.normal(size=(n, 8)).astype(np.float32)
        off = (0.5 * rng.normal(size=n)).astype(np.float32)
        eta = 0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.4 * X[:, 2] * X[:, 3] + off
        y = ((rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float32)
             if dist == "bernoulli" else eta + 0.2 * rng.normal(size=n))
        fr = Frame.from_numpy(np.column_stack([X, off, y]), names=names)
        return fr.asfactor("label") if dist == "bernoulli" else fr

    for dist in ("bernoulli", "gaussian"):
        fr, fv = frame(4000, dist), frame(1500, dist)
        params = dict(ntrees=8, max_depth=4, seed=42, distribution=dist,
                      offset_column="off")
        a = _pair_fit(H2OGradientBoostingEstimator, str(dev), params, fr, fv)
        b = _pair_fit(H2OGradientBoostingEstimator, "cpu", params, fr, fv)
        nodes, dv = _forest_diff(a, b)
        dp = _pred_diff(a, b, fv)
        out[f"offset_{dist}"] = dict(differing_nodes=nodes,
                                     max_value_diff=dv, max_predict_diff=dp)
        if nodes or dp > 1e-5:
            bad.append(f"offset {dist}: {nodes} nodes differ, predictions "
                       f"{dp:.3e} apart")
    X, y = make_higgs_like(4000, n_feat=8, seed=5)
    fx = Frame.from_numpy(np.column_stack([X, y]),
                          names=[f"f{i}" for i in range(8)] + ["label"]
                          ).asfactor("label")
    Xs = np.asarray(make_higgs_like(500, n_feat=8, seed=6)[0])
    Xs[rng.random(Xs.shape) < 0.05] = np.nan
    fs = Frame.from_numpy(Xs, names=[f"f{i}" for i in range(8)])
    for name, cls, params in (
            ("gbm", H2OGradientBoostingEstimator,
             dict(ntrees=10, max_depth=5, seed=42)),
            ("drf", H2ORandomForestEstimator,
             dict(ntrees=5, max_depth=8, seed=42, hist_method="pallas"))):
        m = _pair_fit(cls, str(dev), params, fx)
        # the f64 results: a contributions frame keeps its columns in f32
        rows = torch.from_numpy(m._matrix(fs))
        scale = 1.0 / m.ntrees_built if m.mode == "drf" else 1.0
        f0 = m.f0 if np.ndim(m.f0) == 0 else m.f0[0]
        card = ts.compute_contributions(m.forest[0], m.covers[0],
                                        rows.to(m.device), scale, f0)
        host = ts.compute_contributions(_cpu_forest(m.forest[0]),
                                        m.covers[0].cpu(), rows, scale, f0)
        err = float((card.cpu() - host).abs().max())
        out[f"contributions_{name}"] = err
        if not err <= 1e-10:
            bad.append(f"{name} contributions {err:.3e} from the CPU's")
    print("small explain checks: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# phases 24-28: cross-validation and the stacked ensemble on phase 4's
# frame. The DRF's CV is cut to CV_DRF_TREES trees from DRF_TREES: six
# 50-tree fits would add ≈100 s
CV_FOLDS, CV_DRF_TREES, CV_SMALL_FOLDS = 5, 10, 3
SE_ROWS = 100_000


class cv_spies:
    """Counts `build_bins` calls and times each tree `_fit` and each
    holdout prediction while it is entered: wrappers set on the package's
    names here, in the smoke, and taken off on exit."""

    def __enter__(self):
        from h2o3_tpu_torch.models import shared_tree

        self.mod, self.cls = shared_tree, shared_tree.H2OSharedTreeEstimator
        self.saved = (shared_tree.build_bins, self.cls._fit,
                      self.cls._cv_predict, self.cls._cv_predict_codes)
        self.bins_calls, self.fits, self.predict_s = 0, [], 0.0
        real_bins, real_fit, real_pred, real_codes = self.saved

        def bins(*a, **kw):
            self.bins_calls += 1
            return real_bins(*a, **kw)

        def fit(est, x, y, train, valid):
            torch.cuda.synchronize()
            t0 = time.time()
            model = real_fit(est, x, y, train, valid)
            torch.cuda.synchronize()
            self.fits.append(dict(rows=int(model.bm.codes.shape[0]),
                                  wall_s=time.time() - t0,
                                  bins_s=model.fit_timings["bins_s"],
                                  trees_s=model.fit_timings["trees_s"]))
            return model

        def timed(real):
            def call(est, model, data):
                t0 = time.time()
                out = real(est, model, data)
                self.predict_s += time.time() - t0
                return out
            return call

        shared_tree.build_bins = bins
        self.cls._fit = fit
        self.cls._cv_predict = timed(real_pred)
        self.cls._cv_predict_codes = timed(real_codes)
        return self

    def __exit__(self, *exc):
        (self.mod.build_bins, self.cls._fit, self.cls._cv_predict,
         self.cls._cv_predict_codes) = self.saved


def cv_rebin(value: str):
    """H2O3_CV_REBIN set to `value` while the context is entered."""
    return mock.patch.dict(os.environ, {"H2O3_CV_REBIN": value})


def _check_holdout(est, fr, y, nfolds, seed, bad, tag):
    """The holdout covers every row once: finite probabilities, the fold
    sizes are the reference's Random assignment's
    (`default_rng(seed).integers(0, nfolds, n)`), and fold 0's rows hold
    what its model predicts for them, on the path the fit took."""
    model = est.model
    n = len(y)
    ho = model._cv_holdout_pred
    assign = np.random.default_rng(seed).integers(0, nfolds, n)
    if ho is None or ho.shape != (n,) or not np.all(np.isfinite(ho)) \
            or ho.min() < 0 or ho.max() > 1:
        bad.append(f"{tag}: holdout missing, of the wrong shape or not a "
                   "probability")
        return
    sizes = [n - int(m.bm.codes.shape[0])
             for m in model.cross_validation_models]
    if sizes != [int((assign == f).sum()) for f in range(nfolds)]:
        bad.append(f"{tag}: fold sizes {sizes} are not the assignment's")
    idx = np.nonzero(assign == 0)[0]
    fold0 = model.cross_validation_models[0]
    if fold0.bm.edges is model.bm.edges:       # the reuse path
        own = est._cv_predict_codes(fold0, model.bm.codes[idx])
    else:
        own = est._cv_predict(fold0, fr.take(idx))
    if not np.array_equal(own, ho[idx]):
        bad.append(f"{tag}: fold 0's holdout rows differ from its model's "
                   "prediction of them")


def cv_tree_path(dev, fr, y_np, card):
    """Phases 24-25: the 5-fold GBM on both fold paths and the 5-fold
    10-tree DRF; returns their records and estimators."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    cv = dict(nfolds=CV_FOLDS, keep_cross_validation_predictions=True,
              seed=42, device=str(dev))
    out, ests, bad = {}, {}, []
    for path in ("reuse", "rebin"):
        est = H2OGradientBoostingEstimator(
            ntrees=NTREES, max_depth=DEPTH, learn_rate=0.1,
            histogram_type="UniformAdaptive", **cv)
        with cv_rebin("1" if path == "rebin" else "0"), cv_spies() as spy:
            zero_counts()
            t0 = time.time()
            est.train(y="label", training_frame=fr)
            torch.cuda.synchronize()
            wall = time.time() - t0
        rec = dict(card=card, path=path, wall_s=wall,
                   holdout_predict_s=spy.predict_s,
                   build_bins_calls=spy.bins_calls, fits=spy.fits,
                   xval_auc=float(est.auc(xval=True)),
                   xval_logloss=float(est.logloss(xval=True)),
                   train_auc=float(est.auc()), hist_launches=hist_cuda.launches,
                   hist_rows_launches=hist_cuda.launches_rows,
                   score_launches=score_cuda.launches,
                   score_plans=dict(resident=score_cuda.launches_resident,
                                    streamed=score_cuda.launches_streamed),
                   dispatch=dict(histogram.DISPATCH))
        print(f"cv gbm {path}: " + json.dumps(rec), flush=True)
        out[f"gbm_{path}"], ests[f"gbm_{path}"] = rec, est
        expect = (CV_FOLDS + 1) * NTREES * DEPTH
        bins_expect = 1 if path == "reuse" else CV_FOLDS + 1
        # re-bin folds score their holdout and their fold metrics through
        # the forest kernels; reuse folds walk the codes
        score_expect = 0 if path == "reuse" else 2 * CV_FOLDS
        if rec["build_bins_calls"] != bins_expect:
            bad.append(f"gbm {path}: build_bins ran {rec['build_bins_calls']} "
                       f"times, expected {bins_expect}")
        if rec["hist_launches"] != expect or rec["dispatch"] != {
                "pallas_factored": expect} or rec["hist_rows_launches"]:
            bad.append(f"gbm {path}: B1 {rec['hist_launches']} launches, "
                       f"dispatch {rec['dispatch']}; expected {expect} B1 "
                       "launches and no other method")
        if rec["score_launches"] != score_expect or \
                rec["score_plans"]["streamed"]:
            bad.append(f"gbm {path}: {rec['score_launches']} forest launches "
                       f"({rec['score_plans']}); expected {score_expect}, "
                       "resident")
        if rec["xval_auc"] < 0.75:
            bad.append(f"gbm {path}: xval AUC {rec['xval_auc']} below 0.75")
        _check_holdout(est, fr, y_np, CV_FOLDS, 42, bad, f"gbm {path}")
    a, b = ests["gbm_reuse"].model, ests["gbm_rebin"].model
    cmp = dict(auc_diff=abs(out["gbm_reuse"]["xval_auc"]
                            - out["gbm_rebin"]["xval_auc"]),
               logloss_diff=abs(out["gbm_reuse"]["xval_logloss"]
                                - out["gbm_rebin"]["xval_logloss"]),
               holdout_mean_abs_diff=float(np.mean(np.abs(
                   a._cv_holdout_pred - b._cv_holdout_pred))))
    print("cv gbm reuse vs rebin: " + json.dumps(cmp), flush=True)
    out["gbm_paths"] = cmp
    if cmp["auc_diff"] >= 0.03 or cmp["logloss_diff"] >= 0.03 \
            or cmp["holdout_mean_abs_diff"] >= 0.05:
        bad.append(f"gbm reuse vs rebin beyond the reference's bars: {cmp}")

    print(f"phase 25 cut: the DRF's CV fits {CV_DRF_TREES} trees a model, "
          f"reduced from {DRF_TREES} (six {DRF_TREES}-tree fits would add "
          "≈100 s)", flush=True)
    drf = H2ORandomForestEstimator(ntrees=CV_DRF_TREES, hist_method="pallas",
                                   **cv)
    with cv_spies() as spy:
        zero_counts()
        t0 = time.time()
        drf.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
        wall = time.time() - t0
    m = drf.model
    planned = sum(
        mm.ntrees_built * len(histogram_level_plan(mm.max_depth, mm.compact_cap))
        + mm.dense_rebuilds * len(histogram_level_plan(mm.max_depth))
        for mm in [m] + list(m.cross_validation_models))
    rec = dict(card=card, wall_s=wall, holdout_predict_s=spy.predict_s,
               build_bins_calls=spy.bins_calls, fits=spy.fits,
               max_depth_used=m.max_depth,
               dense_rebuilds=[mm.dense_rebuilds for mm in
                               [m] + list(m.cross_validation_models)],
               oob_auc=float(drf.auc()), xval_auc=float(drf.auc(xval=True)),
               xval_logloss=float(drf.logloss(xval=True)),
               hist_rows_launches=hist_cuda.launches_rows,
               planned_passes=planned, hist_launches=hist_cuda.launches,
               score_launches=score_cuda.launches,
               dispatch=dict(histogram.DISPATCH))
    print("cv drf: " + json.dumps(rec), flush=True)
    out["drf"], ests["drf"] = rec, drf
    if rec["hist_rows_launches"] != planned or rec["hist_launches"] \
            or rec["dispatch"] != {"pallas": planned}:
        bad.append(f"drf: B2 {rec['hist_rows_launches']} launches, B1 "
                   f"{rec['hist_launches']}, dispatch {rec['dispatch']}; "
                   f"expected {planned} B2 launches (the level plans) only")
    if rec["build_bins_calls"] != 1 or rec["score_launches"]:
        bad.append(f"drf: build_bins {rec['build_bins_calls']}, forest "
                   f"launches {rec['score_launches']}; expected 1 and 0")
    if rec["xval_auc"] < DRF_AUC_FLOOR - 0.05:
        bad.append(f"drf: xval AUC {rec['xval_auc']} too low")
    _check_holdout(drf, fr, y_np, CV_FOLDS, 42, bad, "drf")
    if bad:
        raise AssertionError("; ".join(bad))
    return out, ests


def cv_glm_and_ensemble(dev, fr, ests, card):
    """Phases 26-27: the 5-fold binomial GLM, then the stacked ensemble of
    the reuse-path GBM, the DRF and the GLM: AUC against the best base
    model's xval AUC, β ≥ 0, `predict` of SE_ROWS fresh rows against the
    ensemble's MOJO, the forest launches of that `predict`."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                           H2OStackedEnsembleEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.ops import score_cuda

    bad = []
    glm = H2OGeneralizedLinearEstimator(
        family="binomial", lambda_=0.0, nfolds=CV_FOLDS, seed=42,
        keep_cross_validation_predictions=True, device=str(dev))
    kc = kernel_counts()
    t0 = time.time()
    glm.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    glm_rec = dict(card=card, wall_s=time.time() - t0,
                   xval_auc=float(glm.auc(xval=True)),
                   train_auc=float(glm.auc()),
                   parent_split=glm.model.fit_timings,
                   fold_splits=[mm.fit_timings for mm in
                                glm.model.cross_validation_models])
    print("cv glm: " + json.dumps(glm_rec), flush=True)
    if kernel_counts() != kc:
        bad.append("the GLM's CV launched a hand-written kernel")
    ho = glm.model._cv_holdout_pred
    if ho is None or ho.shape != (fr.nrow,) or not np.all(np.isfinite(ho)):
        bad.append("glm: holdout missing or not finite")

    bases = [ests["gbm_reuse"], ests["drf"], glm]
    se = H2OStackedEnsembleEstimator(base_models=bases, device=str(dev))
    t0 = time.time()
    se.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    se_wall = time.time() - t0
    beta = np.asarray(se.model.meta.model.beta)
    best = max(b.auc(xval=True) for b in bases)
    Xt, yt = make_higgs_like(SE_ROWS, seed=9)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    ft = Frame.from_numpy(np.column_stack([Xt, yt]),
                          names=names).asfactor("label")
    zero_counts()
    t1 = time.time()
    pred = se.predict(ft)
    pred_s = time.time() - t1
    launches = dict(score=score_cuda.launches,
                    resident=score_cuda.launches_resident,
                    streamed=score_cuda.launches_streamed,
                    **{k: v for k, v in kernel_counts().items()
                       if k != "score"})
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_se_") as d:
        t2 = time.time()
        path = mojo.save_model(se.model, d, "se.h2o3")
        save_s = time.time() - t2
        size_mb = os.path.getsize(path) / 1e6
        t3 = time.time()
        got = mojo.load_model(path).predict(ft)
        mojo_s = time.time() - t3
    p_card = np.asarray(pred.vec("1").data, np.float64)
    p_mojo = np.asarray(got.vec("1").data, np.float64)
    err = float(np.abs(p_card - p_mojo).max())
    rec = dict(card=card, fit_wall_s=se_wall, auc=float(se.auc()),
               best_base_xval_auc=float(best),
               base_xval_aucs=[float(b.auc(xval=True)) for b in bases],
               metalearner_beta=beta.tolist(), predict_rows=SE_ROWS,
               predict_s=pred_s, predict_launches=launches,
               mojo_mb=size_mb, mojo_save_s=save_s, mojo_predict_s=mojo_s,
               mojo_max_abs_err=err)
    print("stacked ensemble: " + json.dumps(rec), flush=True)
    if rec["auc"] < best - 0.03:
        bad.append(f"SE AUC {rec['auc']} below the best base model's xval "
                   f"AUC {best} less 0.03")
    if (beta[:-1] < 0).any():
        bad.append(f"metalearner β has a negative weight: {beta}")
    if launches != dict(score=2, resident=1, streamed=1, hist=0, hist_rows=0,
                        shap=0):
        bad.append(f"SE predict launched {launches}; expected the GBM's "
                   "resident and the DRF's streamed forest launch only")
    if not err <= 1e-5 or pred.names != ["predict", "0", "1"]:
        bad.append(f"SE MOJO scores {err:.3e} away from the card")
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(glm=glm_rec, se=rec)


def small_cv_checks(dev, card):
    """Phase 28: card against CPU on a small frame (4000 x 8, binary
    labels), 3-fold CV: the GBM and the DRF on both fold paths (fold
    forests equal node for node; holdouts and xval metrics within 1e-5,
    the DRF's AUC on holdouts rounded to 1e-6), the GLM (fold β within
    1e-4, holdout within 1e-5) and the ensemble of the reuse-path models
    (predictions within 1e-5)."""
    from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                           H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator,
                                           H2OStackedEnsembleEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    cv = dict(nfolds=CV_SMALL_FOLDS, seed=42,
              keep_cross_validation_predictions=True)
    cases = {
        "gbm": (H2OGradientBoostingEstimator,
                dict(ntrees=5, max_depth=4, histogram_type="UniformAdaptive")),
        "drf": (H2ORandomForestEstimator,
                dict(ntrees=5, max_depth=10, hist_method="pallas")),
    }
    out, bad, fits = {}, [], {}
    for path in ("reuse", "rebin"):
        for name, (cls, params) in cases.items():
            pair = {}
            with cv_rebin("1" if path == "rebin" else "0"):
                for d in (str(dev), "cpu"):
                    est = cls(device=d, **params, **cv)
                    est.train(y="label", training_frame=fr)
                    pair[d] = est
            a, b = pair[str(dev)].model, pair["cpu"].model
            nodes = sum(_forest_diff(fa, fb)[0] for fa, fb in zip(
                a.cross_validation_models, b.cross_validation_models))
            dv = max(_forest_diff(fa, fb)[1] for fa, fb in zip(
                a.cross_validation_models, b.cross_validation_models))
            dh = float(np.abs(a._cv_holdout_pred - b._cv_holdout_pred).max())
            if name == "drf":
                da = abs(auc_exact(y, np.round(a._cv_holdout_pred, 6))
                         - auc_exact(y, np.round(b._cv_holdout_pred, 6)))
            else:
                da = abs(a.auc(xval=True) - b.auc(xval=True))
            dl = abs(a.logloss(xval=True) - b.logloss(xval=True))
            rec = dict(differing_nodes=nodes, max_value_diff=dv,
                       max_holdout_diff=dh, xval_auc_diff=da,
                       xval_logloss_diff=dl)
            out[f"{name}_{path}"] = rec
            fits[f"{name}_{path}"] = pair
            print(f"small cv {name} {path}: " + json.dumps(rec), flush=True)
            if nodes or max(dv, dh, da, dl) > 1e-5:
                bad.append(f"small cv {name} {path}: card and CPU differ "
                           f"({rec})")
    glms = {}
    for d in (str(dev), "cpu"):
        est = H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                            device=d, **cv)
        est.train(y="label", training_frame=fr)
        glms[d] = est
    a, b = glms[str(dev)].model, glms["cpu"].model
    db = max(float(np.abs(np.asarray(fa.beta) - np.asarray(fb.beta)).max())
             for fa, fb in zip(a.cross_validation_models,
                               b.cross_validation_models))
    dh = float(np.abs(a._cv_holdout_pred - b._cv_holdout_pred).max())
    out["glm"] = dict(max_fold_beta_diff=db, max_holdout_diff=dh)
    print("small cv glm: " + json.dumps(out["glm"]), flush=True)
    if db > 1e-4 or dh > 1e-5:
        bad.append(f"small cv glm: card and CPU differ ({out['glm']})")
    preds = {}
    for d in (str(dev), "cpu"):
        se = H2OStackedEnsembleEstimator(
            base_models=[fits["gbm_reuse"][d], fits["drf_reuse"][d], glms[d]],
            device=d)
        se.train(y="label", training_frame=fr)
        preds[d] = np.asarray(se.predict(fr).vec("1").data, np.float64)
    ds = float(np.abs(preds[str(dev)] - preds["cpu"]).max())
    out["se"] = dict(max_predict_diff=ds)
    print(f"small cv se: max |predict diff| {ds:.3e} ({card})", flush=True)
    if ds > 1e-5:
        bad.append(f"small cv se: card and CPU predictions differ by {ds}")
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# phase 29: szilard/benchm-ml's Airlines GBM (github.com/szilard/benchm-ml,
# its H2O GBM run: max_depth 16, learn_rate 0.01, nbins 100, 1000 trees, a
# 100k-row test set) on a generated frame of its eight features and label.
# Origin and Dest have 300 levels, so nbins = max(101, min(301, 1024)) =
# 301 and the codes are 16-bit. The GBM is cut to BM_TREES trees from
# 1000, the DRF (H2O's defaults) to BM_DRF_TREES from 50
BM_ROWS, BM_TEST, BM_SMALL = 1_000_000, 100_000, 20_000
BM_Y = "dep_delayed_15min"
BM_LEVELS = dict(Month=12, DayofMonth=31, DayOfWeek=7, UniqueCarrier=22,
                 Origin=300, Dest=300)
BM_GBM = dict(distribution="bernoulli", max_depth=16, learn_rate=0.01,
              nbins=100, seed=42)
BM_TREES, BM_DRF_TREES = 10, 5
BM_NBINS = 301
# Origin codes with a delay effect: a right fit splits at both ends, past 255
BM_HUB = (264, 288)
# phase 29's kernel checks: bins and level widths
BM_CHECK_BINS, BM_CHECK_WIDTHS = (301, 1024), (1, 64, 4096)


def make_airlines_bm_like(n: int, seed: int):
    """benchm-ml's Airlines columns in its order: the enums Month (12
    levels), DayofMonth (31), DayOfWeek (7), UniqueCarrier (22), Origin
    (300), Dest (300), the numerics DepTime (hhmm, 1-2359) and Distance,
    and the label dep_delayed_15min (N/Y, about 19 % Y) from a logistic
    model in them, whose strongest term is a block of Origin codes past
    255 (BM_HUB). Airports take a skewed share of the traffic (weights
    1 / (rank + 5) over a fixed order of the levels). Returns (frame, the
    generator's P(Y) per row)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec

    rng = np.random.default_rng(seed)
    codes = {}
    for name, k in BM_LEVELS.items():
        if name in ("Origin", "Dest"):
            rank = np.random.default_rng(k + len(name)).permutation(k)
            w = 1.0 / (rank + 5.0)
            codes[name] = rng.choice(k, n, p=w / w.sum())
        else:
            codes[name] = rng.integers(0, k, n)
    dep = rng.integers(1, 2400, n)
    dist = np.round(np.abs(rng.normal(800, 500, n)) + 30)
    o, d = codes["Origin"], codes["Dest"]
    eff = (-1.9 + 0.0009 * (dep - 1200)
           + 0.3 * np.isin(codes["Month"], [5, 6, 11])
           + 0.15 * (codes["DayOfWeek"] >= 4)
           + 0.25 * (codes["UniqueCarrier"] % 5 == 0)
           + 1.3 * ((o >= BM_HUB[0]) & (o < BM_HUB[1]))
           - 0.5 * ((d >= 270) & (d < 285)) + 1e-4 * (dist - 800))
    p = 1 / (1 + np.exp(-eff))
    y = (rng.random(n) < p).astype(np.int32)
    names = dict(Month="c-{:02d}", DayofMonth="c-{:02d}",
                 DayOfWeek="c-{}", UniqueCarrier="UC{:02d}",
                 Origin="A{:03d}", Dest="A{:03d}")

    def enum(name):
        return Vec(codes[name], "enum", domain=[
            names[name].format(i + 1 if name.startswith(("Month", "Day"))
                               else i) for i in range(BM_LEVELS[name])])

    vecs = {c: enum(c) for c in ("Month", "DayofMonth", "DayOfWeek")}
    vecs["DepTime"] = Vec(dep.astype(np.float32))
    vecs["UniqueCarrier"] = enum("UniqueCarrier")
    vecs["Origin"] = enum("Origin")
    vecs["Dest"] = enum("Dest")
    vecs["Distance"] = Vec(dist.astype(np.float32))
    vecs[BM_Y] = Vec(y, "enum", domain=["N", "Y"])
    return Frame(vecs), p


def bm_plan_passes(depth: int, cap: int, trees: int, rebuilds: int):
    """{(L, root pass): passes per tree} of a fit's level plan: every
    tree's first attempt and, averaged, its dense rebuilds."""
    from h2o3_tpu_torch.models.tree import histogram_level_plan

    per = Counter()
    for plan, weight in ((histogram_level_plan(depth, cap), 1.0),
                         (histogram_level_plan(depth), rebuilds / trees)):
        if weight:
            for label, L in plan:
                per[(L, label == "d0")] += weight
    return dict(per)


def airlines_bm_path(dev, card):
    """Phase 29, the fits: the GBM (B1) on BM_ROWS rows, its training AUC,
    `predict` and AUC on BM_TEST fresh rows; the DRF (B2) and its OOB AUC.
    Fails unless the codes are 16-bit, every pass launched the kernel and
    nothing else, and the GBM splits Origin or Dest at a bin past 255.
    Returns (records, the training codes, each fit's passes per tree)."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram

    bad = []
    t0 = time.time()
    fr, _ = make_airlines_bm_like(BM_ROWS, 0)
    ft, p_test = make_airlines_bm_like(BM_TEST, 1)
    gen_s = time.time() - t0
    y_test = np.asarray(ft.vec(BM_Y).data)
    out, passes = {}, {}
    for algo in ("gbm", "drf"):
        if algo == "gbm":
            est = H2OGradientBoostingEstimator(ntrees=BM_TREES,
                                               device=str(dev), **BM_GBM)
        else:
            est = H2ORandomForestEstimator(ntrees=BM_DRF_TREES, seed=42,
                                           hist_method="pallas",
                                           device=str(dev))
        zero_counts()
        t1 = time.time()
        est.train(y=BM_Y, training_frame=fr)
        torch.cuda.synchronize()
        wall = time.time() - t1
        m = est.model
        b1, b2 = hist_cuda.launches, hist_cuda.launches_rows
        dispatch = dict(histogram.DISPATCH)
        ntrees = BM_TREES if algo == "gbm" else BM_DRF_TREES
        expect = (ntrees * len(histogram_level_plan(m.max_depth,
                                                    m.compact_cap))
                  + m.dense_rebuilds * len(histogram_level_plan(m.max_depth)))
        passes[algo] = bm_plan_passes(m.max_depth, m.compact_cap, ntrees,
                                      m.dense_rebuilds)
        f = m.forest[0]
        at = [m.x.index("Origin"), m.x.index("Dest")]
        wide = int((f.is_split & (f.bin >= 256)
                    & ((f.feat == at[0]) | (f.feat == at[1]))).sum())
        rec = dict(card=card, rows=BM_ROWS, wall_s=wall, nbins=m.bm.nbins,
                   codes=str(m.bm.codes.dtype), max_depth_used=m.max_depth,
                   compact_cap=m.compact_cap, dense_rebuilds=m.dense_rebuilds,
                   fit_timings=m.fit_timings, b1_launches=b1, b2_launches=b2,
                   planned_passes=expect, dispatch=dispatch,
                   origin_dest_splits_past_255=wide)
        if algo == "gbm":
            rec["train_auc"] = float(est.auc())
            t2 = time.time()
            pred = est.predict(ft)
            rec["predict_s"] = time.time() - t2
            p1 = np.asarray(pred.vec("Y").data, np.float64)
            rec.update(predict_rows=BM_TEST, holdout_auc=auc_exact(y_test, p1),
                       generator_auc=auc_exact(y_test, p_test),
                       frames_s=gen_s)
            if pred.names != ["predict", "N", "Y"] or pred.nrow != BM_TEST \
                    or not np.all(np.isfinite(p1)):
                bad.append("airlines GBM predict frame wrong or not finite")
            if not rec["holdout_auc"] >= 0.6:
                bad.append(f"airlines GBM holdout AUC {rec['holdout_auc']}")
            if wide == 0:
                bad.append("the airlines GBM never splits Origin or Dest at "
                           "a bin past 255")
            launches, method = b1, "pallas_factored"
        else:
            rec["oob_auc"] = float(est.auc())
            if not rec["oob_auc"] >= 0.55:
                bad.append(f"airlines DRF OOB AUC {rec['oob_auc']}")
            launches, method = b2, "pallas"
        print(f"airlines {algo}: " + json.dumps(rec), flush=True)
        if m.bm.nbins != BM_NBINS or m.bm.codes.dtype != np.uint16:
            bad.append(f"airlines {algo}: {m.bm.nbins} bins, "
                       f"{m.bm.codes.dtype} codes")
        if launches != expect or dispatch != {method: expect} \
                or b1 + b2 != launches:
            bad.append(f"airlines {algo}: dispatch {dispatch}, B1 {b1}, B2 "
                       f"{b2}; expected {expect} {method} launches only")
        out[algo] = rec
        if algo == "gbm":
            codes = m.bm.codes
        del est, m
    if bad:
        raise AssertionError("; ".join(bad))
    print(f"phase 29 cuts: the GBM fits {BM_TREES} trees, reduced from "
          f"benchm-ml's 1000; the DRF {BM_DRF_TREES}, reduced from H2O's "
          "default 50", flush=True)
    return out, codes, passes


def bm_pass_inputs(rng, dev, L, root, w_rate=None):
    """Node ids and vals (3, BM_ROWS) of one pass: every row weighted at a
    GBM root (or at w_rate, the DRF's in-bag share), about half in a
    sibling pass; g normal, h uniform."""
    rate = w_rate if w_rate is not None else (1.0 if root else 0.5)
    w = (rng.random(BM_ROWS) < rate).astype(np.float32)
    g = rng.normal(size=BM_ROWS).astype(np.float32)
    h = rng.random(BM_ROWS).astype(np.float32)
    vals = torch.from_numpy(np.stack([w, g * w, h * w])).to(dev)
    node = torch.from_numpy(rng.integers(0, L, BM_ROWS,
                                         dtype=np.int32)).to(dev)
    return node, vals, int(w.sum())


def bm_library_ms(dev, codes_fm, node, vals, L, nbins):
    """One `index_add_` computing the same histogram: flat ids
    f·L·B + node·B + code into an (F·L·B, 3) buffer."""
    F = codes_fm.shape[0]
    ids = (torch.arange(F, device=dev, dtype=torch.int64)[:, None]
           * (L * nbins) + node.to(torch.int64)[None, :] * nbins
           + codes_fm.to(torch.int64)).reshape(-1)
    src = vals.t().repeat(F, 1)
    buf = torch.zeros((F * L * nbins, 3), device=dev)
    ms = time_ms(lambda: buf.zero_().index_add_(0, ids, src), reps=3,
                 warmup=1)
    del ids, src, buf
    return ms


def wide_kernels(dev, fit_codes, passes):
    """Phase 29, the kernels on 16-bit codes at N = BM_ROWS, F = 8: at
    B in BM_CHECK_BINS (301: the fit's own codes; 1024: uniform codes) and
    L in BM_CHECK_WIDTHS, B1 bit-equal to `hist_plain_fixed`, within rtol
    1e-5 of `hist_plain` and no farther from f64 in any channel; B2
    within rtol 1e-5, atol 1e-5·max of `hist_plain_rows`; each timed with
    the L2 flushed beside its bound (2 bytes a code). Then every width of
    the two fits' plans at B = 301, checked and timed with the plain and
    `index_add_` versions, weighted by its passes per tree. Returns the
    two kernel entries' numbers."""
    from h2o3_tpu_torch.ops import hist_cuda, packing

    rng = np.random.default_rng(29)
    F = fit_codes.shape[1]
    laws = {301: torch.from_numpy(packing.device_codes(fit_codes)).to(dev),
            1024: torch.from_numpy(rng.integers(0, 1024, (BM_ROWS, F),
                                                dtype=np.int16)).to(dev)}
    worst = dict(b1=0.0, b2=0.0)

    def b1_check(cfm, node, vals, L, nbins, f64_check):
        got = hist_cuda.hist_build(cfm, node, vals, L, nbins)
        again = hist_cuda.hist_build(cfm, node, vals, L, nbins)
        fixed = hist_cuda.hist_plain_fixed(cfm, node, vals, L, nbins)
        ref = hist_cuda.hist_plain(cfm, node, vals, L, nbins)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got, fixed)):
            raise AssertionError(f"B1 at B={nbins}, L={L}: not equal to "
                                 "hist_plain_fixed or to a second launch")
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        worst["b1"] = max(worst["b1"], float((got - ref).abs().max()))
        errs = None
        if f64_check:
            f64 = hist_cuda.hist_plain(cfm, node, vals, L, nbins,
                                       torch.float64)
            errs = [[float(e) for e in (x.double() - f64).abs()
                     .reshape(-1, 3).amax(0)] for x in (got, ref)]
            del f64
            if any(k > p for k, p in zip(*errs)):
                raise AssertionError(
                    f"B1 at B={nbins}, L={L} lies farther from f64 than "
                    f"hist_plain: {channels(errs[0])} against "
                    f"{channels(errs[1])}")
        del got, again, fixed, ref
        return errs

    def b2_check(crm, node, vals, L, nbins):
        got = hist_cuda.hist_build_rows(crm, node, vals, L, nbins)
        ref = hist_cuda.hist_plain_rows(crm, node, vals, L, nbins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        worst["b2"] = max(worst["b2"], float((got - ref).abs().max()))
        del got, ref

    for nbins in BM_CHECK_BINS:
        crm = laws[nbins]
        cfm = crm.t().contiguous()
        for L in BM_CHECK_WIDTHS:
            node, vals, n_w = bm_pass_inputs(rng, dev, L, L == 1)
            errs = b1_check(cfm, node, vals, L, nbins, True)
            ms1 = time_ms_cold(lambda: hist_cuda.hist_build(
                cfm, node, vals, L, nbins), reps=5, warmup=1)
            b2_check(crm, node, vals, L, nbins)
            ms2 = time_ms_cold(lambda: hist_cuda.hist_build_rows(
                crm, node, vals, L, nbins), reps=5, warmup=1)
            bound, nbytes = bound_ms_of(n_w, L, F, nbins, 2, BM_ROWS)
            p1 = hist_cuda.block_plan(L, nbins, F, BM_ROWS, code_bytes=2)
            p2 = hist_cuda.rows_plan(L, nbins, F, BM_ROWS)
            print(f"16-bit B={nbins} L={L}: B1 {ms1:.4f} ms ({p1.grid[2]} "
                  f"node slices of {p1.nodes_per_block}, {p1.grid[1]} "
                  f"feature blocks, {p1.grid[0]} row blocks), B2 {ms2:.4f} "
                  f"ms (G={p2.group_nodes}, {p2.grid[1]} feature blocks); "
                  f"bytes bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, 2 B "
                  f"a code); B1 equals hist_plain_fixed, max |err| vs f64 "
                  f"(w/g·w/h·w) {channels(errs[0])} (hist_plain "
                  f"{channels(errs[1])})", flush=True)
        del cfm
    # the fits' own plans at B = 301, weighted by passes per tree
    crm = laws[301]
    cfm = crm.t().contiguous()
    del laws
    totals = {}
    for algo, kind in (("gbm", "b1"), ("drf", "b2")):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        for (L, root), per_tree in sorted(passes[algo].items()):
            node, vals, n_w = bm_pass_inputs(
                rng, dev, L, root, 0.632 if kind == "b2" and root else None)
            if kind == "b1":
                b1_check(cfm, node, vals, L, BM_NBINS, False)
                ms = time_ms_cold(lambda: hist_cuda.hist_build(
                    cfm, node, vals, L, BM_NBINS), reps=5, warmup=1)
            else:
                b2_check(crm, node, vals, L, BM_NBINS)
                ms = time_ms_cold(lambda: hist_cuda.hist_build_rows(
                    crm, node, vals, L, BM_NBINS), reps=5, warmup=1)
            plain = time_ms(lambda: (
                hist_cuda.hist_plain(cfm, node, vals, L, BM_NBINS)
                if kind == "b1" else hist_cuda.hist_plain_rows(
                    crm, node, vals, L, BM_NBINS)), reps=3, warmup=1)
            lib = bm_library_ms(dev, cfm, node, vals, L, BM_NBINS)
            bound, _ = bound_ms_of(n_w, L, F, BM_NBINS, 2, BM_ROWS)
            for k, v in (("ms", ms), ("plain_ms", plain),
                         ("bound_ms", bound), ("library_ms", lib)):
                tot[k] += per_tree * v
            print(f"16-bit {algo} pass L={L} {'root' if root else 'sibling'}"
                  f" ({per_tree:g} a tree): {kind.upper()} {ms:.4f} ms, "
                  f"plain {plain:.4f}, index_add_ {lib:.4f}, bound "
                  f"{bound:.4f}", flush=True)
        tot["max_abs_err"] = worst[kind]
        totals[algo] = tot
        print(f"16-bit {algo} tree ({kind.upper()}, B={BM_NBINS}): "
              + json.dumps(tot), flush=True)
    return totals


def _leaves_diff(a, b, fr):
    """(rows of `fr` whose leaf differs in some tree, max |leaf value diff|
    over the leaves those rows reach) of two models, on the f32 rows
    `predict` routes."""
    from h2o3_tpu_torch.models.tree import Tree, forest_leaves

    X = torch.from_numpy(a._matrix(fr).astype(np.float32))
    rows, dv = 0, 0.0
    for fa, fb in zip(a.forest, b.forest):
        fa, fb = (Tree(*[t.cpu() for t in f]) for f in (fa, fb))
        la = forest_leaves(fa, X, a.max_depth)
        lb = forest_leaves(fb, X, b.max_depth)
        rows += int((la != lb).any(dim=0).sum())
        dv = max(dv, float((fa.value.gather(1, la)
                            - fb.value.gather(1, lb)).abs().max()))
    return rows, dv


def small_bm_checks(dev, card):
    """Phase 29, card against CPU: the generator's frame cut to BM_SMALL
    rows, a DRF ("pallas", depth 8) and a GBM (benchm-ml's settings, depth
    8), 5 trees each. The DRF's sums are exact (0/1 weights and labels):
    its forest structure must be equal, leaf values and predictions within
    1e-5. The GBM's are not, and two things part the card's forest from
    the CPU's on this frame without any fault. Tree 0's gradients take two
    values, so in nodes of a few dozen rows the best splits on two
    features often isolate the same count of rows and positives, an exact
    tie in real arithmetic that f32 sums in another order break either way;
    the GBM is fit with a weights column (uniform in [0.5, 1.5], seeded) so
    that distinct row sets do not tie. And a 300-level enum leaves most
    bins of a deep node empty: sibling subtraction (right = parent - left)
    leaves f32 residues there, of the root's magnitude times the f32
    epsilon, which decide between thresholds that part the node's rows the
    same way. So the GBM must route every training row to the same leaf of
    every tree, with leaf values there and predictions within 1e-5; the
    nodes whose split differs are printed."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec

    fr, _ = make_airlines_bm_like(BM_SMALL, 5)
    w = np.random.default_rng(BM_SMALL).uniform(0.5, 1.5, BM_SMALL)
    frw = Frame({**{n: fr.vec(n) for n in fr.names},
                 "w": Vec(w.astype(np.float32))})
    cases = (("drf", H2ORandomForestEstimator, fr,
              dict(ntrees=5, max_depth=8, seed=42, hist_method="pallas")),
             ("gbm_weighted", H2OGradientBoostingEstimator, frw,
              dict(BM_GBM, max_depth=8, ntrees=5, weights_column="w")))
    bad = []
    for name, cls, frame, params in cases:
        a = _pair_fit(cls, str(dev), params, frame, y=BM_Y)
        b = _pair_fit(cls, "cpu", params, frame, y=BM_Y)
        nodes, dv = _forest_diff(a, b)
        rows, dleaf = _leaves_diff(a, b, frame)
        dp = _pred_diff(a, b, frame)
        rec = dict(card=card, rows=BM_SMALL, nbins=a.bm.nbins,
                   differing_nodes=nodes, max_value_diff=dv,
                   rows_in_other_leaves=rows, max_leaf_value_diff=dleaf,
                   max_predict_diff=dp)
        print(f"small airlines {name}: " + json.dumps(rec), flush=True)
        same = (not nodes and dv <= 1e-5) if name == "drf" else not rows
        if not same or dleaf > 1e-5 or dp > 1e-5 or a.bm.nbins != BM_NBINS:
            bad.append(f"small airlines {name}: card and CPU differ "
                       f"({nodes} nodes, {rows} rows in other leaves, leaf "
                       f"values {dleaf:.3e}, predictions {dp:.3e})")
    if bad:
        raise AssertionError("; ".join(bad))

# phase 30: the multinomial GLM on phase 14's Covertype-shaped frames (H2O's
# GLM documentation fits its multinomial example on Covertype). A ridge of
# λ = 1e-5 (α = 0) gives the softmax one optimum: the one-hot area and soil
# columns are collinear, and a rare class is separable on some soil types
# at λ = 0. The stack's GBM is COV_GBM cut to MN_GBM_TREES trees from 50,
# without early stopping; both base models have MN_FOLDS folds
MN_GLM = dict(family="multinomial", alpha=0.0, lambda_=1e-5)
MN_FOLDS, MN_GBM_TREES = 3, 10
MN_SERVE_TOL = 1e-5
# the CPU test's tolerance for centred β (tests/test_torch_glm_multinomial.py)
MN_BETA_TOL = 3e-4
MN_CLASSES = ["ash", "birch", "cedar", "dogwood"]


def _mn_probs(frame, k: int) -> np.ndarray:
    return np.column_stack([np.asarray(frame.vec(c).data, np.float64)
                            for c in frame.names[1:1 + k]])


def _mn_labels(frame) -> list:
    """The `predict` column's labels (its codes index the frame's own
    domain, which differs between frames)."""
    v = frame.vec("predict")
    return [v.domain[c] for c in np.asarray(v.data)]


def multinomial_glm_path(dev, fr, fv):
    """Phase 30: the 7-class GLM at full width through the public API
    (fitted twice, the second checked), its f64 gradient, a profiled fit,
    `predict` against the MOJO, the serving engine, a MN_FOLDS-fold CV
    GLM and its stack with a MN_FOLDS-fold GBM; returns its record."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                           H2OGradientBoostingEstimator,
                                           H2OStackedEnsembleEstimator)
    from h2o3_tpu_torch.models import estimator_engine, glm as glmlib
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    tf32_off()
    card = card_line()
    bad = []

    def fit():
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        est = H2OGeneralizedLinearEstimator(device=str(dev), **MN_GLM)
        est.train(y="cover", training_frame=fr, validation_frame=fv)
        torch.cuda.synchronize()
        return (est.model, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev), kernel_counts())

    # the first fit pays the first use of the expansion's and the loss's
    # kernels; the second is the steady state, and is checked
    first, first_wall, _, _ = fit()
    m, wall, peak, counts = fit()
    plan, ft = m.fitplan, m.fit_timings
    N, P = fr.nrow, len(m.dinfo.coef_names) + 1
    # the f64 objective and its gradient at the returned β, on the card
    _, Xd = estimator_engine.design_matrix(fr, m.x, standardize=True,
                                           add_intercept=True, device=dev)
    design_bytes = Xd.numel() * Xd.element_size()
    X64 = Xd.double()
    del Xd
    ycodes = torch.as_tensor(np.asarray(fr.vec("cover").data, np.int64),
                             device=dev)
    loss64, grad64 = glmlib._softmax_loss_grad(
        X64, ycodes, torch.ones(N, dtype=torch.float64, device=dev),
        torch.as_tensor(m.beta, device=dev), MN_GLM["lambda_"], N)
    grad64_norm = float(torch.linalg.norm(grad64))
    del X64, grad64
    expand_bound = _design_bytes(m.dinfo, N, P) / HBM_BYTES_PER_S * 1e3
    ytr = np.asarray(fr.vec("cover").data)
    yv = np.asarray(fv.vec("cover").data)
    prior = np.bincount(ytr, minlength=COV_K) / len(ytr)
    prior_logloss = float(-np.mean(np.log(prior[yv])))
    prof = profile_fit(H2OGeneralizedLinearEstimator(device=str(dev),
                                                     **MN_GLM),
                       fr, tag="multinomial glm profile", y="cover",
                       valid=fv)
    # predict of the validation frame against the numpy MOJO scorer (f64)
    t1 = time.perf_counter()
    pred = m.predict(fv)
    predict_s = time.perf_counter() - t1
    probs = _mn_probs(pred, COV_K)
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_mnglm_") as d:
        t2 = time.perf_counter()
        path = mojo.save_model(m, d, "glm.h2o3")
        save_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        got = mojo.load_model(path).predict(fv)
        mojo_s = time.perf_counter() - t3
    mojo_err = float(np.abs(_mn_probs(got, COV_K) - probs).max())
    labels_equal = _mn_labels(got) == _mn_labels(pred)
    rec = dict(card=card, rows=N, valid_rows=fv.nrow, p=P, classes=COV_K,
               params=MN_GLM, path=plan["path"], steps=plan["iterations"],
               func_evals=plan["func_evals"], converged=plan["converged"],
               loss=plan["loss"], grad_norm_f32=plan["grad_norm"],
               loss_f64=float(loss64), grad_norm_f64=grad64_norm,
               wall_s=wall, fit_timings=ft, peak_bytes=peak,
               design_bytes=design_bytes, expand_bound_ms=expand_bound,
               first_fit=dict(wall_s=first_wall, timings=first.fit_timings,
                              steps=first.fitplan["iterations"]),
               train_logloss=float(m.logloss()),
               valid_logloss=float(m.logloss(valid=True)),
               train_mean_per_class_error=float(m.mean_per_class_error()),
               valid_mean_per_class_error=float(
                   m.mean_per_class_error(valid=True)),
               prior_logloss=prior_logloss,
               busy_share=prof["busy_share"], profiled_wall_s=prof["wall_s"],
               predict_s=predict_s, mojo_save_s=save_s,
               mojo_predict_s=mojo_s, mojo_max_abs_err=mojo_err,
               max_row_sum_err=float(np.abs(probs.sum(1) - 1).max()),
               kernel_counts=counts)
    print("multinomial glm: " + json.dumps(rec), flush=True)
    print(f"multinomial glm on {card}: {N} x {P}, {COV_K} classes, "
          f"{plan['iterations']} L-BFGS steps ({plan['func_evals']} loss "
          f"evaluations), fit {wall:.3f} s = design {ft['pack_s']:.3f} host "
          f"pack + {ft['h2d_s']:.3f} H2D + {ft['expand_s'] * 1e3:.3f} ms "
          f"expansion (bound {expand_bound:.4f} ms), L-BFGS "
          f"{ft['lbfgs_s']:.3f}, metrics {ft['metrics_s']:.3f}; loss "
          f"{plan['loss']:.9f}, f64 gradient norm {grad64_norm:.3e}; "
          f"logloss {rec['train_logloss']:.6f} train, "
          f"{rec['valid_logloss']:.6f} valid (prior {prior_logloss:.6f}); "
          f"design {design_bytes / 1e6:.1f} MB; busy "
          f"{prof['busy_share'] * 100:.2f} % of a profiled fit", flush=True)
    cap = max(glmlib.LBFGS_MIN_STEPS, 4 * 50)     # max_iterations' default
    if plan["path"] != "lbfgs" or not 1 <= plan["iterations"] <= cap:
        bad.append(f"the fit left the L-BFGS path or its step cap: {plan}")
    if any(counts.values()):
        bad.append(f"the GLM fit launched a hand-written kernel: {counts}")
    if not (rec["train_logloss"] < prior_logloss
            and rec["valid_logloss"] < prior_logloss):
        bad.append("logloss not below the class priors'")
    if not np.all(np.isfinite(probs)) or rec["max_row_sum_err"] > 1e-5:
        bad.append("probabilities non-finite or rows off 1")
    if not mojo_err <= 1e-5 or not labels_equal:
        bad.append(f"predict differs from the MOJO scorer by {mojo_err:.3e}")
    if not grad64_norm <= 1e-3:
        bad.append(f"f64 gradient norm {grad64_norm:.3e} at the fit's β")

    # the serving engine: requests of 1..SERVE_MAX_ROWS validation rows
    rng = np.random.default_rng(31)
    xs = fv[COV_NAMES]
    reqs = [xs.take(np.arange(s, s + n)) for s, n in zip(
        rng.integers(0, fv.nrow - SERVE_MAX_ROWS, SERVE_REQUESTS),
        rng.integers(1, SERVE_MAX_ROWS + 1, SERVE_REQUESTS))]
    engine = ScoringEngine(ServingConfig())
    zero_counts()
    t4 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVE_THREADS) as ex:
        served = list(ex.map(lambda r: engine.score("mn_glm", m, r), reqs))
    serve_s = time.perf_counter() - t4
    serve_counts = kernel_counts()
    snap = engine.snapshot()
    engine.shutdown()
    # cuBLAS picks its GEMM by row count, so a served batch and a lone
    # `predict` round the logits apart in their last bits (1.0e-6 in
    # probability measured): MN_SERVE_TOL, and the labels equal wherever
    # the top two probabilities are more than 2·MN_SERVE_TOL apart
    worst, same_labels = 0.0, True
    for r, o in zip(reqs, served):
        want = m.predict(r)
        if o.names != want.names or o.nrow != r.nrow:
            bad.append(f"served {o.names} x {o.nrow}")
            break
        pw = _mn_probs(want, COV_K)
        worst = max(worst, float(np.abs(_mn_probs(o, COV_K) - pw).max()))
        top2 = np.sort(pw, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * MN_SERVE_TOL
        same_labels &= bool((np.asarray(_mn_labels(o))[clear]
                             == np.asarray(_mn_labels(want))[clear]).all())
    tot, fo = snap["totals"], snap["failover"]
    serve_rec = dict(card=card, requests=len(reqs),
                     rows=sum(r.nrow for r in reqs), threads=SERVE_THREADS,
                     burst_s=serve_s, batches=tot["batches"],
                     max_abs_err=worst, labels_equal=same_labels,
                     cache_misses=snap["cache"]["misses"],
                     fallback_scores=tot["fallback_scores"],
                     errors=tot["errors"], kernel_counts=serve_counts)
    print("multinomial glm serving: " + json.dumps(serve_rec), flush=True)
    if worst > MN_SERVE_TOL or not same_labels or tot["fallback_scores"] \
            or fo["fallback_builds"] or tot["errors"] \
            or snap["cache"]["misses"] != 1 or any(serve_counts.values()):
        bad.append("serving the multinomial GLM: " + json.dumps(serve_rec))

    # MN_FOLDS-fold CV of the same GLM, the holdout kept for the stack
    cv_glm = H2OGeneralizedLinearEstimator(
        device=str(dev), nfolds=MN_FOLDS, seed=42,
        keep_cross_validation_predictions=True, **MN_GLM)
    zero_counts()
    t5 = time.perf_counter()
    cv_glm.train(y="cover", training_frame=fr)
    torch.cuda.synchronize()
    cv_wall = time.perf_counter() - t5
    cv_counts = kernel_counts()
    ho = cv_glm.model._cv_holdout_pred
    cv_rec = dict(card=card, folds=MN_FOLDS, wall_s=cv_wall,
                  xval_logloss=float(cv_glm.logloss(xval=True)),
                  xval_mean_per_class_error=float(
                      cv_glm.model.mean_per_class_error(xval=True)),
                  parent_split=cv_glm.model.fit_timings,
                  fold_splits=[mm.fit_timings for mm in
                               cv_glm.model.cross_validation_models],
                  fold_steps=[mm.fitplan["iterations"] for mm in
                              cv_glm.model.cross_validation_models],
                  kernel_counts=cv_counts)
    print("multinomial glm cv: " + json.dumps(cv_rec), flush=True)
    if ho is None or ho.shape != (N, COV_K) or not np.all(np.isfinite(ho)) \
            or float(np.abs(ho.sum(1) - 1).max()) > 1e-5:
        bad.append("cv glm: holdout missing, non-finite or rows off 1")
    if any(cv_counts.values()):
        bad.append(f"the GLM's CV launched a hand-written kernel: {cv_counts}")

    # the multiclass stack: the CV GLM and a MN_FOLDS-fold 7-class GBM
    print(f"phase 30 cut: the stack's GBM fits {MN_GBM_TREES} trees a "
          f"class, reduced from COV_GBM's {COV_GBM['ntrees']}, without early "
          f"stopping; both base models have {MN_FOLDS} folds", flush=True)
    gbm = H2OGradientBoostingEstimator(
        device=str(dev), nfolds=MN_FOLDS, keep_cross_validation_predictions=True,
        **dict(COV_GBM, ntrees=MN_GBM_TREES, stopping_rounds=0))
    zero_counts()
    t6 = time.perf_counter()
    gbm.train(y="cover", training_frame=fr)
    torch.cuda.synchronize()
    gbm_wall = time.perf_counter() - t6
    gbm_b1 = hist_cuda.launches
    se = H2OStackedEnsembleEstimator(base_models=[gbm, cv_glm],
                                     device=str(dev))
    t7 = time.perf_counter()
    se.train(y="cover", training_frame=fr)
    torch.cuda.synchronize()
    se_wall = time.perf_counter() - t7
    meta = se.model.meta.model
    zero_counts()
    t8 = time.perf_counter()
    se_pred = se.predict(fv)
    se_pred_s = time.perf_counter() - t8
    se_launches = dict(score=score_cuda.launches,
                       resident=score_cuda.launches_resident,
                       **{k: v for k, v in kernel_counts().items()
                          if k != "score"})
    se_probs = _mn_probs(se_pred, COV_K)
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_mnse_") as d:
        path = mojo.save_model(se.model, d, "se.h2o3")
        size_mb = os.path.getsize(path) / 1e6
        t9 = time.perf_counter()
        se_got = mojo.load_model(path).predict(fv)
        se_mojo_s = time.perf_counter() - t9
    se_err = float(np.abs(_mn_probs(se_got, COV_K) - se_probs).max())
    xval = [float(gbm.logloss(xval=True)), float(cv_glm.logloss(xval=True))]
    se_rec = dict(card=card, gbm_trees=MN_GBM_TREES, gbm_wall_s=gbm_wall,
                  gbm_b1_launches=gbm_b1,
                  gbm_xval_logloss=xval[0], glm_xval_logloss=xval[1],
                  fit_wall_s=se_wall, logloss=float(se.model.logloss()),
                  valid_logloss=float(se.model.model_performance(fv).logloss),
                  meta_family=meta.family, meta_steps=meta.fitplan[
                      "iterations"], meta_grad_norm=meta.fitplan["grad_norm"],
                  predict_s=se_pred_s, predict_launches=se_launches,
                  mojo_mb=size_mb, mojo_predict_s=se_mojo_s,
                  mojo_max_abs_err=se_err)
    print("multinomial stack: " + json.dumps(se_rec), flush=True)
    # the level-one columns are probabilities and the metalearner's link a
    # softmax, so the stack need not reach its best member's logloss (the
    # reference ignores metalearner_transform, ROADMAP §C); it must beat
    # its weaker member and the priors
    if meta.family != "multinomial" or not (
            se_rec["logloss"] < max(xval)
            and se_rec["valid_logloss"] < prior_logloss):
        bad.append(f"stack logloss {se_rec['logloss']} not below the weaker "
                   f"base model's xval logloss {max(xval)}, or its "
                   f"validation logloss {se_rec['valid_logloss']} not below "
                   f"the priors' {prior_logloss}")
    if se_launches != dict(score=COV_K, resident=COV_K, hist=0, hist_rows=0,
                           shap=0):
        bad.append(f"stack predict launched {se_launches}; expected the "
                   f"GBM's {COV_K} resident forest launches only")
    if not se_err <= 1e-5 or se_pred.names != ["predict"] + [
            str(k) for k in range(COV_K)]:
        bad.append(f"stack MOJO scores {se_err:.3e} away from the card")
    if bad:
        raise AssertionError("; ".join(bad))
    tf32_off()
    return dict(glm=rec, serving=serve_rec, cv=cv_rec, stack=se_rec)


def mn_small_frame(n: int, seed: int):
    """The CPU test's 4-class frame (tests/test_torch_glm_multinomial.py,
    `mn_frame` with a categorical predictor): numeric a (3 % NaN), b, c, a
    four-level enum g, labels drawn from a softmax over class scores."""
    from h2o3_tpu_torch.frame.frame import Frame

    law = np.random.default_rng(104)
    W = law.normal(size=(4, 3)) * 0.6
    Wg = law.normal(size=(4, 4)) * 0.5
    rng = np.random.default_rng(seed)
    a, b, c = rng.normal(size=n), rng.uniform(0, 4, n), rng.normal(size=n)
    eta = np.column_stack([a, b - 2.0, c]) @ W.T
    g = rng.integers(0, 4, n)
    eta += Wg.T[g]
    y = (eta - np.log(-np.log(rng.random((n, 4))))).argmax(1)
    a = a.copy()
    a[rng.random(n) < 0.03] = np.nan
    return Frame.from_dict(
        {"a": a, "b": b, "c": c,
         "g": np.asarray(["north", "east", "south", "west"], dtype=object)[g],
         "y": np.asarray(MN_CLASSES, dtype=object)[y]},
        column_types={"g": "enum", "y": "enum"})


def small_multinomial_glm_checks(dev, card):
    """Phase 30, card against CPU (whose fit the CPU tests hold against the
    JAX package) on the CPU test's 4-class frame at 4000 rows, λ = 0: the
    centred β (B − mean_k B_k) within MN_BETA_TOL, predictions of a
    validation frame within 1e-4, and a MN_FOLDS-fold CV's holdouts within
    1e-4. The two stop where their own sums of the loss first repeat, so
    their steps may differ."""
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    fr, fv = mn_small_frame(4000, 0), mn_small_frame(1500, 1)
    fits = {}
    for d in (str(dev), "cpu"):
        est = H2OGeneralizedLinearEstimator(
            family="multinomial", lambda_=0.0, nfolds=MN_FOLDS, seed=42,
            keep_cross_validation_predictions=True, device=d)
        est.train(y="y", training_frame=fr, validation_frame=fv)
        fits[d] = est.model
    a, b = fits[str(dev)], fits["cpu"]

    def centred(B):
        B = np.asarray(B, np.float64)
        return B - B.mean(axis=0)

    rec = dict(
        card=card, steps=[a.fitplan["iterations"], b.fitplan["iterations"]],
        max_centred_beta_diff=float(np.abs(centred(a.beta)
                                           - centred(b.beta)).max()),
        max_predict_diff=float(np.abs(_mn_probs(a.predict(fv), 4)
                                      - _mn_probs(b.predict(fv), 4)).max()),
        max_holdout_diff=float(np.abs(a._cv_holdout_pred
                                      - b._cv_holdout_pred).max()),
        valid_logloss=[float(a.logloss(valid=True)),
                       float(b.logloss(valid=True))])
    print("small multinomial glm: " + json.dumps(rec), flush=True)
    if rec["max_centred_beta_diff"] > MN_BETA_TOL \
            or rec["max_predict_diff"] > 1e-4 \
            or rec["max_holdout_diff"] > 1e-4:
        raise AssertionError(f"small multinomial GLM: card and CPU differ "
                             f"({rec})")
    return rec


# phase 31: XGBoost. (a) runs on a frame of MSLR-WEB30K's published shape
# (Qin & Liu, "Introducing LETOR 4.0 Datasets", arXiv:1306.2597, and the
# MSLR-WEB30K page): 31,531 queries and 3,771,125 documents of 136
# features, labels 0-4, at most 1,251 documents a query; one fold trains on
# three of its five parts
MSLR_QUERIES, MSLR_DOCS, MSLR_FEAT, MSLR_MAX_DOCS = 31_531, 3_771_125, 136, 1_251
MSLR_TRAIN_QUERIES = round(MSLR_QUERIES * 3 / 5)
MSLR_TRAIN_DOCS = round(MSLR_DOCS * 3 / 5)
# the generator's label shares, falling from 0 to 4 as graded relevance's do
MSLR_LABEL_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)
XGB_TREES, XGB_DEPTH, XGB_NBINS = 50, 6, 256   # bench.py's trees; defaults
# AutoML's XGBoost_1 and XGBoost_2 (h2o3_tpu/automl/automl.py:167-171)
XGB_1 = dict(ntrees=50, max_depth=6, learn_rate=0.3, sample_rate=0.8,
             col_sample_rate_per_tree=0.8, reg_lambda=1.0)
XGB_2 = dict(ntrees=50, max_depth=10, learn_rate=0.2, sample_rate=0.6,
             col_sample_rate_per_tree=0.8, reg_lambda=1.0, min_rows=5.0)
XGB_2_TREES = 3
XGB_PREDICT_ROWS, XGB_SHAP_ROWS = 100_000, 10_000
DART_ROUNDS, DART_RATE = 20, 0.1
GBLINEAR_ROUNDS = 50
# the reference's lambdarank fixture (tests/test_automl.py:36-55) and fit
XGB_RANK_SMALL = dict(ntrees=20, max_depth=4, eta=0.3, seed=4,
                      objective="rank:ndcg", group_column="qid")
PHASE31_WALLS: dict = {}


def make_mslr_like(seed: int):
    """A frame of MSLR-WEB30K's published shape, one fold's training part:
    MSLR_TRAIN_QUERIES queries of MSLR_TRAIN_DOCS documents, each query's
    documents contiguous as in the LETOR files. The law: query sizes
    gamma(1.5) with the data set's mean, rounded and clipped to [1, 1,251],
    query 0 at 1,251, the total then matched by ±1 steps on random other
    queries; feature j standard normal (j % 3 == 0, scores), lognormal
    (j % 3 == 1, BM25-like) or Poisson(3) counts (j % 3 == 2), f32; a
    latent score z = x0 + 0.6·ln x1 + 0.4·(x2 − 3)/√3 + 0.5·x3 + 0.5·x6 +
    a query effect N(0, 0.5²); labels 0-4 at the quantiles of
    MSLR_LABEL_SHARES of z + noise N(0, 0.8²). Returns (frame, qid,
    labels, z)."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    Q, N = MSLR_TRAIN_QUERIES, MSLR_TRAIN_DOCS
    sizes = np.clip(np.round(rng.gamma(1.5, N / Q / 1.5, Q)), 1,
                    MSLR_MAX_DOCS).astype(np.int64)
    sizes[0] = MSLR_MAX_DOCS
    while int(sizes.sum()) != N:
        diff = N - int(sizes.sum())
        np.add.at(sizes, rng.integers(1, Q, abs(diff)), 1 if diff > 0 else -1)
        sizes[1:] = np.clip(sizes[1:], 1, MSLR_MAX_DOCS)
    qid = np.repeat(np.arange(Q), sizes)
    cols = {}
    for j in range(MSLR_FEAT):
        if j % 3 == 0:
            cols[f"f{j}"] = rng.standard_normal(N, dtype=np.float32)
        elif j % 3 == 1:
            cols[f"f{j}"] = np.exp(rng.standard_normal(N, dtype=np.float32))
        else:
            cols[f"f{j}"] = rng.poisson(3.0, N).astype(np.float32)
    z = (cols["f0"] + 0.6 * np.log(cols["f1"])
         + 0.4 * (cols["f2"] - 3.0) / np.sqrt(3.0)
         + 0.5 * cols["f3"] + 0.5 * cols["f6"]).astype(np.float64)
    z += rng.normal(0.0, 0.5, Q)[qid]
    noisy = z + rng.normal(0.0, 0.8, N)
    rel = np.digitize(noisy, np.quantile(noisy,
                                         np.cumsum(MSLR_LABEL_SHARES)[:-1]))
    del noisy
    cols["qid"] = qid.astype(np.float64)
    cols["rel"] = rel.astype(np.float32)
    return Frame.from_dict(cols), qid, rel.astype(np.float64), z


def b1_passes(dev, codes_fm, nbins, widths, seed, check=True, n_rows=None):
    """B1 at each pass of `widths` (the first a root pass, every row
    weighted; the others sibling passes, about half) on feature-major
    codes: with `check`, bit-equal to `hist_plain_fixed`, repeatable, and
    no farther from f64 than `hist_plain` in any channel (`check_b1`);
    times with the L2 flushed, and with `check` the plain version's, one
    `index_add_`'s and the bytes bound. Returns one record a pass."""
    from h2o3_tpu_torch.ops import hist_cuda

    F, N = codes_fm.shape
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(widths):
        node, vals = pass_inputs(rng, dev, L, i > 0, n=N)
        n_w = int((vals[0] != 0).sum())
        rec = dict(L=L, sibling=i > 0, weighted_rows=n_w)
        rec["ms"] = time_ms_cold(
            lambda: hist_cuda.hist_build(codes_fm, node, vals, L, nbins),
            reps=10, warmup=2)
        rec["bound_ms"], rec["bytes"] = bound_ms_of(
            n_w, L, n_feat=F, nbins=nbins, n_rows=N)
        if check:
            rec["max_abs_err"], rec["f64_err"], rec["plain_f64_err"] = \
                check_b1(codes_fm, node, vals, L, nbins)
            rec["plain_ms"] = time_ms(
                lambda: hist_cuda.hist_plain(codes_fm, node, vals, L, nbins),
                reps=3, warmup=1)
            rec["library_ms"] = bm_library_ms(dev, codes_fm, node, vals, L,
                                              nbins)
        out.append(rec)
        del node, vals
    return out


def _fit_codes_fm(model, dev):
    """A fitted tree model's training codes, feature-major, on the card."""
    return torch.from_numpy(np.ascontiguousarray(model.bm.codes.T)).to(dev)


def xgb_rank_path(dev, card):
    """Phase 31(a): `rank:ndcg` lambdarank on a frame of MSLR-WEB30K's
    shape (BASELINE.json config 4) at the reference's defaults."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.models import tree as treelib
    from h2o3_tpu_torch.models import xgboost as xgb
    from h2o3_tpu_torch.models.metrics import ndcg_at_k
    from h2o3_tpu_torch.ops import hist_cuda, histogram

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr, qid, rel, z = make_mslr_like(0)
    gen_s = time.perf_counter() - t0
    sizes = np.bincount(qid)
    x = [f"f{j}" for j in range(MSLR_FEAT)]
    print(f"phase 31(a) frame (MSLR-WEB30K's shape, one fold's training "
          f"part): {len(sizes)} queries, {len(qid)} documents, {MSLR_FEAT} "
          f"features; documents a query: mean {sizes.mean():.2f}, median "
          f"{np.median(sizes):.0f}, max {sizes.max()}; labels 0-4: "
          f"{np.bincount(rel.astype(int), minlength=5).tolist()}; made in "
          f"{gen_s:.2f} s", flush=True)
    print(f"phase 31(a) cut: none ({XGB_TREES} trees, bench.py's count)",
          flush=True)
    orig = xgb._lambdarank_pass
    events, shapes = [], []
    nonfinite = torch.zeros((), dtype=torch.bool, device=dev)

    def timed(margin, chunks, n_rows, disc):
        if not shapes:
            shapes.extend(tuple(c.idx.shape) for c in chunks)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g, h = orig(margin, chunks, n_rows, disc)
        b.record()
        events.append((a, b))
        nonfinite.logical_or_(~(torch.isfinite(g).all()
                                & torch.isfinite(h).all()))
        return g, h

    # where the tree loop's time goes: CUDA events around each tree build,
    # each B1 launch and each leaf-total pass of the fit
    spans = {"build_tree": [], "b1": [], "leaf_totals": []}

    def spanned(name, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return run

    est = H2OXGBoostEstimator(objective="rank:ndcg", group_column="qid",
                              ntrees=XGB_TREES, max_depth=XGB_DEPTH, seed=1,
                              device=str(dev))
    zero_counts()
    with mock.patch.object(xgb, "_lambdarank_pass", timed), \
            mock.patch.object(treelib, "build_tree", spanned(
                "build_tree", treelib.build_tree)), \
            mock.patch.object(treelib, "_leaf_totals", spanned(
                "leaf_totals", treelib._leaf_totals)), \
            mock.patch.object(hist_cuda, "hist_build", spanned(
                "b1", hist_cuda.hist_build)):
        t0 = time.perf_counter()
        est.train(x=x, y="rel", training_frame=fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, dispatch = kernel_counts(), dict(histogram.DISPATCH)
    m = est.model
    pass_ms = [a.elapsed_time(b) for a, b in events]
    span_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
              for k, v in spans.items()}
    t0 = time.perf_counter()
    scores = m._margins(m._matrix(fr))[:, 0]
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nd_model = ndcg_at_k(rel, scores, qid, 10)
    ndcg_ms = (time.perf_counter() - t0) * 1e3
    nd_zero = ndcg_at_k(rel, np.zeros(len(rel)), qid, 10)
    nd_latent = ndcg_at_k(rel, z, qid, 10)
    del fr, z
    codes = _fit_codes_fm(m, dev)
    passes = b1_passes(dev, codes, XGB_NBINS, LEVEL_WIDTHS, 31, check=False)
    del codes
    pairs = sum(q * g * g for q, g in shapes)
    ft = m.fit_timings
    rec = dict(queries=int(len(sizes)), documents=int(len(qid)),
               features=MSLR_FEAT, trees=m.ntrees_built, wall_s=wall,
               fit_timings=ft, b1_launches=counts["hist"],
               dispatch=dispatch, kernel_counts=counts,
               lambdarank_rounds=len(pass_ms),
               lambdarank_ms_median=float(np.median(pass_ms)),
               lambdarank_ms_total=float(np.sum(pass_ms)),
               lambdarank_chunks=len(shapes), pair_elements=int(pairs),
               ndcg10_model=nd_model, ndcg10_zero=nd_zero,
               ndcg10_latent=nd_latent, ndcg_host_ms=ndcg_ms,
               score_train_s=score_s, fit_spans_s=span_s,
               b1_ms_per_tree=sum(r["ms"] for r in passes),
               b1_bound_ms_per_tree=sum(r["bound_ms"] for r in passes),
               b1_passes=[(r["L"], r["ms"], r["bound_ms"]) for r in passes],
               description=m.training_metrics.description)
    print("xgb rank: " + json.dumps(rec), flush=True)
    print(f"xgb rank on {card}: fit {wall:.3f} s = bins {ft['bins_s']:.3f} "
          f"+ upload {ft['upload_s']:.3f} + trees {ft['trees_s']:.3f} + "
          f"metrics {ft['metrics_s']:.3f}; lambdarank pass "
          f"{rec['lambdarank_ms_median']:.3f} ms a round (median of "
          f"{len(pass_ms)}, CUDA events; {len(shapes)} chunks, {pairs} pair "
          f"elements), {rec['lambdarank_ms_total'] / 1e3:.3f} s in all; "
          f"build_tree {span_s['build_tree']:.3f} s of it B1 "
          f"{span_s['b1']:.3f} s and leaf totals {span_s['leaf_totals']:.3f} "
          f"s (CUDA events in the fit); B1 "
          f"{counts['hist']} launches, {rec['b1_ms_per_tree']:.3f} ms a "
          f"depth-6 tree at B = {XGB_NBINS}, F = {MSLR_FEAT} (bound "
          f"{rec['b1_bound_ms_per_tree']:.4f}); NDCG@10 model {nd_model:.5f}, "
          f"zero model {nd_zero:.5f}, latent score {nd_latent:.5f}; "
          f"ndcg_at_k {ndcg_ms:.1f} ms on the host", flush=True)
    bad = []
    if not nd_model > nd_zero:
        bad.append(f"NDCG@10 {nd_model:.5f} not above the zero model's "
                   f"{nd_zero:.5f}")
    # the fit's one forest launch scores the training rows for its NDCG
    if counts["hist"] != XGB_TREES * XGB_DEPTH or set(dispatch) != {
            "pallas_factored"} or counts["hist_rows"] or counts["shap"] \
            or counts["score"] != 1:
        bad.append(f"histogram dispatch {dispatch}, counts {counts}; "
                   f"expected {XGB_TREES * XGB_DEPTH} B1 launches and one "
                   "forest launch")
    if bool(nonfinite) or len(pass_ms) != XGB_TREES:
        bad.append(f"lambdarank: NaN or inf in g or h ({bool(nonfinite)}), "
                   f"{len(pass_ms)} passes for {XGB_TREES} rounds")
    PHASE31_WALLS["a"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 31(a): " + "; ".join(bad))
    return rec


def xgb_automl_path(dev, fr, card):
    """Phase 31(b) and (c): AutoML's XGBoost_1 on phase 4's frame (fit,
    AUC, `predict`, contributions against `tree_shap_plain`), B1 at B = 256
    on its codes at each pass of a depth-6 tree, and XGBoost_2's depth 10
    cut to XGB_2_TREES trees. Returns (record, the XGBoost_1 model, the
    kernels line's entry)."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import tree_shap as ts
    from h2o3_tpu_torch.ops import histogram, score_cuda, shap_cuda

    t_phase = time.perf_counter()
    names = [f"f{i}" for i in range(N_FEAT)]
    est = H2OXGBoostEstimator(seed=42, device=str(dev), **XGB_1)
    zero_counts()
    t0 = time.perf_counter()
    est.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, dispatch = kernel_counts(), dict(histogram.DISPATCH)
    m = est.model
    auc = float(est.auc())
    Xt, yt = make_higgs_like(XGB_PREDICT_ROWS, seed=1)
    ft_ = Frame.from_numpy(np.column_stack([Xt, yt]),
                           names=names + ["label"]).asfactor("label")
    zero_counts()
    t0 = time.perf_counter()
    pred = m.predict(ft_)
    pred_s = time.perf_counter() - t0
    plans = dict(resident=score_cuda.launches_resident,
                 streamed=score_cuda.launches_streamed)
    p1 = np.asarray(pred.vec("1").data, np.float64)
    # contributions on fresh rows (5 % NaN): local accuracy, and the
    # kernel against its plain version on the card, bit for bit
    rng = np.random.default_rng(131)
    Xc = score_rows(rng, XGB_SHAP_ROWS)
    fc = Frame.from_numpy(Xc, names=names)
    zero_counts()
    t0 = time.perf_counter()
    C = _contrib_matrix(m.predict_contributions(fc))
    torch.cuda.synchronize()
    shap_s = time.perf_counter() - t0
    shap_launches = shap_cuda.launches
    marg = m._margins(m._matrix(fc))[:, 0]
    local = float((np.abs(C.sum(axis=1) - marg)
                   / np.maximum(1.0, np.abs(marg))).max())
    Xd = torch.from_numpy(np.ascontiguousarray(Xc, np.float64)).to(dev)
    forest, cover = m.forest[0], m.covers[0]
    bias = ts.forest_bias(forest, cover, 1.0)
    got = shap_cuda.tree_shap(forest, cover, Xd, 1.0, bias,
                              plan=m._shap_plan(N_FEAT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ts.tree_shap_plain(forest, cover, Xd, 1.0, bias)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    shap_equal = bool(torch.equal(got, want))
    del Xd, got, want
    # (c) B1 at B = 256 on the fit's codes, each pass of a depth-6 tree
    codes = _fit_codes_fm(m, dev)
    passes = b1_passes(dev, codes, XGB_NBINS, LEVEL_WIDTHS, 32)
    del codes
    # XGBoost_2's depth 10, cut to a few trees: B1 per level width
    est2 = H2OXGBoostEstimator(seed=42, device=str(dev),
                               **dict(XGB_2, ntrees=XGB_2_TREES))
    zero_counts()
    t0 = time.perf_counter()
    est2.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    counts2 = kernel_counts()
    m2 = est2.model
    widths10 = [1] + [2 ** d for d in range(m2.max_depth - 1)]
    codes = _fit_codes_fm(m2, dev)
    passes10 = b1_passes(dev, codes, XGB_NBINS, widths10, 33)
    del codes
    ft, ft2 = m.fit_timings, m2.fit_timings
    rec = dict(
        xgboost_1=dict(wall_s=wall, fit_timings=ft, auc=auc,
                       b1_launches=counts["hist"], dispatch=dispatch,
                       predict_rows=XGB_PREDICT_ROWS, predict_s=pred_s,
                       predict_plans=plans, shap_rows=XGB_SHAP_ROWS,
                       shap_s=shap_s, shap_launches=shap_launches,
                       shap_local_accuracy=local,
                       shap_equal_to_plain=shap_equal, plain_shap_s=plain_s),
        b256_passes=[{k: r[k] for k in ("L", "ms", "plain_ms", "library_ms",
                                        "bound_ms", "max_abs_err")}
                     for r in passes],
        xgboost_2=dict(trees=m2.ntrees_built, depth=m2.max_depth,
                       wall_s=wall2, fit_timings=ft2,
                       b1_launches=counts2["hist"],
                       b1_ms_per_tree=sum(r["ms"] for r in passes10),
                       b1_bound_ms_per_tree=sum(r["bound_ms"]
                                                for r in passes10),
                       b1_per_width=[(r["L"], r["ms"], r["bound_ms"])
                                     for r in passes10]))
    print("xgb automl: " + json.dumps(rec), flush=True)
    tree6 = {k: sum(r[k] for r in passes) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"xgb XGBoost_1 on {card}: 1M x 28, {XGB_1['ntrees']} trees, fit "
          f"{wall:.3f} s (bins {ft['bins_s']:.3f}, upload {ft['upload_s']:.3f}, "
          f"trees {ft['trees_s']:.3f}), AUC {auc:.6f}; predict of "
          f"{XGB_PREDICT_ROWS} rows {pred_s * 1e3:.1f} ms ({plans}); "
          f"contributions of {XGB_SHAP_ROWS} rows {shap_s * 1e3:.1f} ms, "
          f"local accuracy {local:.2e}, kernel equal to tree_shap_plain: "
          f"{shap_equal} (plain {plain_s * 1e3:.1f} ms)", flush=True)
    print(f"xgb B1 at B = {XGB_NBINS}, N = {N_ROWS}, F = {N_FEAT}, 8-bit "
          f"codes, per depth-6 tree: kernel {tree6['ms']:.4f} ms (L2 "
          f"flushed), plain {tree6['plain_ms']:.4f}, index_add_ "
          f"{tree6['library_ms']:.4f}, bound {tree6['bound_ms']:.4f}; per "
          "pass (L, ms, bound): "
          + ", ".join(f"({r['L']}, {r['ms']:.4f}, {r['bound_ms']:.4f})"
                      for r in passes), flush=True)
    print(f"xgb XGBoost_2 depth {m2.max_depth} cut to {XGB_2_TREES} trees "
          f"from {XGB_2['ntrees']}: fit {wall2:.3f} s (trees "
          f"{ft2['trees_s']:.3f}), B1 {counts2['hist']} launches, "
          f"{rec['xgboost_2']['b1_ms_per_tree']:.4f} ms a tree (bound "
          f"{rec['xgboost_2']['b1_bound_ms_per_tree']:.4f}); per width (L, "
          "ms, bound): " + ", ".join(f"({r['L']}, {r['ms']:.4f}, "
                                     f"{r['bound_ms']:.4f})"
                                     for r in passes10), flush=True)
    bad = []
    if auc < 0.75:
        bad.append(f"XGBoost_1 training AUC {auc:.6f} below 0.75")
    if counts["hist"] != XGB_1["ntrees"] * XGB_1["max_depth"] \
            or set(dispatch) != {"pallas_factored"} or counts["hist_rows"]:
        bad.append(f"XGBoost_1 dispatch {dispatch}, counts {counts}")
    if counts2["hist"] != XGB_2_TREES * m2.max_depth:
        bad.append(f"XGBoost_2: {counts2['hist']} B1 launches, expected "
                   f"{XGB_2_TREES * m2.max_depth}")
    if plans != dict(resident=1, streamed=0) or not np.isfinite(p1).all():
        bad.append(f"predict: plans {plans}, finite {np.isfinite(p1).all()}")
    if not local <= 1e-5 or not shap_equal or shap_launches < 1:
        bad.append(f"contributions: local accuracy {local:.3e}, equal to "
                   f"plain {shap_equal}, {shap_launches} launches")
    PHASE31_WALLS["b_c"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 31(b, c): " + "; ".join(bad))
    entry = dict(
        name="hist_factored_b256", route="cuda",
        source="h2o3_tpu_torch/csrc/hist.cu",
        replaces="h2o3_tpu/ops/hist_pallas.py:103",
        launches=counts["hist"],
        max_abs_err=max(r["max_abs_err"] for r in passes), **tree6,
        bound_by="bytes")
    return rec, m, entry


def xgb_dart_path(dev, fr, xgb1_model, card):
    """Phase 31(e): DART on phase 4's frame, DART_ROUNDS rounds at
    rate_drop DART_RATE, both normalize types; skip_drop=1 at XGBoost_1's
    settings equals the first DART_ROUNDS trees of phase 31(b)'s fit bit
    for bit (a round's trees depend on its index, not on the count)."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    t_phase = time.perf_counter()
    rec, bad = {}, []
    for nt in ("tree", "forest"):
        est = H2OXGBoostEstimator(booster="dart", ntrees=DART_ROUNDS,
                                  rate_drop=DART_RATE, normalize_type=nt,
                                  seed=42, device=str(dev))
        zero_counts()
        t0 = time.perf_counter()
        est.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        sc = est.model.dart_scales
        rec[nt] = dict(wall_s=wall, auc=float(est.auc()),
                       trees_s=est.model.fit_timings["trees_s"],
                       rounds_rescaled=int(sum(s != 1.0 for s in sc)),
                       b1_launches=counts["hist"])
        if counts["hist"] != DART_ROUNDS * XGB_DEPTH or counts["hist_rows"]:
            bad.append(f"DART {nt}: counts {counts}")
        if rec[nt]["auc"] < 0.75 or not rec[nt]["rounds_rescaled"]:
            bad.append(f"DART {nt}: AUC {rec[nt]['auc']:.6f}, "
                       f"{rec[nt]['rounds_rescaled']} rounds rescaled")
    est = H2OXGBoostEstimator(booster="dart", rate_drop=DART_RATE,
                              skip_drop=1.0, seed=42, device=str(dev),
                              **dict(XGB_1, ntrees=DART_ROUNDS))
    est.train(y="label", training_frame=fr)
    a, b = est.model.forest[0], xgb1_model.forest[0]
    same = all(torch.equal(fa, fb[:DART_ROUNDS]) for fa, fb in zip(a, b))
    rec["skip_drop_1_equals_gbtree"] = same
    if not same:
        bad.append("DART with skip_drop=1 differs from gbtree's trees")
    print("xgb dart: " + json.dumps(rec), flush=True)
    print(f"xgb DART on {card}: {DART_ROUNDS} rounds, rate_drop {DART_RATE}: "
          + "; ".join(f"{nt} fit {rec[nt]['wall_s']:.3f} s, AUC "
                      f"{rec[nt]['auc']:.6f}, {rec[nt]['rounds_rescaled']} "
                      "rounds rescaled" for nt in ("tree", "forest"))
          + f"; skip_drop=1 equal to gbtree bit for bit: {same}", flush=True)
    PHASE31_WALLS["e"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 31(e): " + "; ".join(bad))
    return rec


def xgb_gblinear_path(dev, fr, glm_rec, card):
    """Phase 31(d): gblinear on phase 17's Airlines frame, binomial,
    GBLINEAR_ROUNDS rounds: the fit's split, AUC beside phase 17's GLM,
    logloss below the priors', β finite, the MOJO round trip."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    t_phase = time.perf_counter()
    tf32_off()
    est = H2OXGBoostEstimator(booster="gblinear", ntrees=GBLINEAR_ROUNDS,
                              device=str(dev))
    zero_counts()
    t0 = time.perf_counter()
    est.train(y="IsDepDelayed", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    m = est.model
    ft = m.fit_timings
    y = np.asarray(fr.vec("IsDepDelayed").data, np.float64)
    pri = y.mean()
    ll_pri = float(-(pri * np.log(pri) + (1 - pri) * np.log(1 - pri)))
    ft_fr, _, _ = make_airlines_like(AIR_TEST, 1)
    pred = m.predict(ft_fr)
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_gbl_") as d:
        got = mojo.load_model(mojo.save_model(m, d, "gbl.h2o3")).predict(ft_fr)
    mojo_err = float(np.abs(np.asarray(got.vec("YES").data, np.float64)
                            - np.asarray(pred.vec("YES").data,
                                         np.float64)).max())
    rec = dict(rows=fr.nrow, p=len(m.beta), rounds=GBLINEAR_ROUNDS,
               wall_s=wall, fit_timings=ft, auc=float(m.auc()),
               glm_auc=glm_rec["auc"], logloss=float(m.logloss()),
               priors_logloss=ll_pri, mojo_max_abs_err=mojo_err,
               beta_finite=bool(np.isfinite(m.beta).all()),
               kernel_counts=counts, algo=m.algo)
    print("xgb gblinear: " + json.dumps(rec), flush=True)
    print(f"xgb gblinear on {card}: {fr.nrow} x {len(m.beta)}, "
          f"{GBLINEAR_ROUNDS} rounds, fit {wall:.3f} s = host pack "
          f"{ft['pack_s']:.3f} + H2D {ft['h2d_s']:.3f} + expansion "
          f"{ft['expand_s'] * 1e3:.3f} ms + rounds {ft['rounds_s']:.3f} + "
          f"metrics {ft['metrics_s']:.3f}; AUC {rec['auc']:.6f} (phase 17's "
          f"GLM {glm_rec['auc']:.6f}); logloss {rec['logloss']:.6f} against "
          f"the priors' {ll_pri:.6f}; MOJO {mojo_err:.2e}", flush=True)
    bad = []
    if not rec["logloss"] < ll_pri or not rec["beta_finite"]:
        bad.append(f"logloss {rec['logloss']} not below the priors' "
                   f"{ll_pri}, or β not finite")
    if not mojo_err <= 1e-5 or m.algo != "xgboost":
        bad.append(f"MOJO {mojo_err:.3e}, algo {m.algo}")
    if any(counts.values()):
        bad.append(f"gblinear launched a tree kernel: {counts}")
    tf32_off()
    PHASE31_WALLS["d"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 31(d): " + "; ".join(bad))
    return rec


def xgb_small_frame(n: int, seed: int, kind: str):
    """The CPU tests' frames (tests/test_torch_xgboost.py::_data): the
    reference test's binomial `_frame`, a 4-class response on the same
    law, or the reference's lambdarank fixture (tests/test_automl.py) with
    a weights column `w` from another seed: the first round's margins are
    all 0, so its gradients take few values and splits that part other
    rows tie exactly; the weights part the tied sets, as in phase 29."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    if kind == "rank":
        nq, per_q = 60, 20
        X = rng.normal(size=(nq * per_q, 5))
        s = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=nq * per_q)
        rel = np.digitize(s, np.quantile(s, [0.5, 0.75, 0.9])).astype(float)
        w = np.random.default_rng(seed + 1).uniform(0.5, 1.5, nq * per_q)
        return Frame.from_dict({**{f"f{i}": X[:, i] for i in range(5)},
                                "qid": np.repeat(np.arange(nq), per_q)
                                .astype(float), "rel": rel, "w": w})
    X = rng.normal(size=(n, 8)).astype(np.float32)
    noise = rng.normal(size=n)
    d = {f"f{i}": X[:, i] for i in range(8)}
    if kind == "binomial":
        d["y"] = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * noise) > 0
                  ).astype(int).astype(str)
    else:
        s = X[:, 0] + 0.8 * X[:, 1] - 0.5 * X[:, 3] + 0.3 * noise
        d["y"] = np.asarray(["a", "b", "c", "d"])[
            np.digitize(s, [-1.0, 0.0, 1.0])]
    return Frame.from_dict(d, column_types={"y": "enum"})


XGB_SMALL_CASES = {
    "gbtree_binomial": ("binomial", 4000, dict(
        ntrees=5, max_depth=4, seed=1, reg_alpha=0.5, max_delta_step=0.7,
        gamma=0.1)),
    "gbtree_multinomial": ("multinomial", 2000, dict(ntrees=4, max_depth=3,
                                                      seed=2)),
    "lambdarank": ("rank", 0, dict(XGB_RANK_SMALL, weights_column="w")),
    "dart": ("binomial", 2000, dict(booster="dart", rate_drop=0.3,
                                    one_drop=True, ntrees=8, max_depth=3,
                                    seed=11)),
    "gblinear": ("binomial", 3000, dict(booster="gblinear", ntrees=30,
                                        reg_lambda=0.5)),
}


def xgb_small_checks(dev, card):
    """Phase 31(f): card against CPU on the CPU tests' small frames:
    forests equal or every row in the same leaf, predictions within 1e-5,
    gblinear β within 1e-4; the card's gbtree and gblinear models served
    (equal to `predict` within 1e-6, no fallback) and through the MOJO
    (within 1e-5)."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    t_phase = time.perf_counter()
    out, bad, served = {}, [], {}
    for name, (kind, n, params) in XGB_SMALL_CASES.items():
        fr = xgb_small_frame(n, 0, kind)
        y = "rel" if kind == "rank" else "y"
        x = [c for c in fr.names if c not in (y, "qid")]
        a, b = (_pair_fit(H2OXGBoostEstimator, d, params, fr, y=y)
                for d in (str(dev), "cpu"))
        if name == "gblinear":
            rec = dict(max_beta_diff=float(np.abs(np.asarray(a.beta)
                                                  - np.asarray(b.beta)).max()))
            if rec["max_beta_diff"] > 1e-4:
                bad.append(f"{name}: β differs by {rec['max_beta_diff']:.3e}")
        else:
            nodes, dv = _forest_diff(a, b)
            rows, lv = _leaves_diff(a, b, fr)
            rec = dict(nodes_differ=nodes, max_value_diff=dv,
                       rows_in_other_leaves=rows, max_leaf_value_diff=lv)
            if rows or lv > 1e-5:
                bad.append(f"{name}: {rows} rows in other leaves, leaf "
                           f"values {lv:.3e} apart")
        rec["max_predict_diff"] = _pred_diff(a, b, fr)
        if rec["max_predict_diff"] > 1e-5:
            bad.append(f"{name}: predictions {rec['max_predict_diff']:.3e}")
        out[name] = rec
        if name in ("gbtree_binomial", "gblinear"):
            served[name] = (a, fr[x])
    engine = ScoringEngine(ServingConfig())
    rng = np.random.default_rng(61)
    worst, mojo_err = 0.0, 0.0
    try:
        for name, (model, fx) in served.items():
            cuts = np.sort(rng.choice(np.arange(1, fx.nrow), 15, replace=False))
            reqs = [fx.take(np.arange(lo, hi)) for lo, hi in
                    zip(np.r_[0, cuts], np.r_[cuts, fx.nrow])]
            with ThreadPoolExecutor(max_workers=4) as ex:
                outs = list(ex.map(lambda r: engine.score(name, model, r),
                                   reqs))
            for r, o in zip(reqs, outs):
                worst = max(worst, float(np.abs(
                    np.asarray(o.vec("1").data, np.float64)
                    - np.asarray(model.predict(r).vec("1").data,
                                 np.float64)).max()))
            with tempfile.TemporaryDirectory(prefix="h2o3_smoke_xgb_") as d:
                got = mojo.load_model(mojo.save_model(model, d, "m.h2o3")
                                      ).predict(fx)
            mojo_err = max(mojo_err, float(np.abs(
                np.asarray(got.vec("1").data, np.float64)
                - np.asarray(model.predict(fx).vec("1").data,
                             np.float64)).max()))
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    tot = snap["totals"]
    out["served"] = dict(max_abs_err=worst, fallback_scores=tot[
        "fallback_scores"], errors=tot["errors"], mojo_max_abs_err=mojo_err)
    if worst > 1e-6 or tot["fallback_scores"] or tot["errors"] \
            or snap["failover"]["fallback_builds"]:
        bad.append("serving: " + json.dumps(out["served"]))
    if mojo_err > 1e-5:
        bad.append(f"MOJO {mojo_err:.3e} from predict")
    print("xgb small checks (card vs cpu): " + json.dumps(out), flush=True)
    PHASE31_WALLS["f"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 31(f): " + "; ".join(bad))
    return out

# phase 32: DeepLearning on an MNIST-shaped frame (LeCun et al., "Gradient-
# based learning applied to document recognition", 1998; the MNIST page:
# 60,000 training and 10,000 test images of 28 x 28 pixels in 0-255, ten
# digits). H2O's DeepLearning benchmark trains on it as a 784-column frame;
# 67 of its pixels (the corners) are zero in every training image, so
# ignore_const_cols keeps 717 columns. DL_EPOCHS is cut from the
# estimator's default 10 to keep the smoke's wall (tools/dl_mnist.py runs
# the default); the width is the default's
DL_ROWS, DL_VALID, DL_CLASSES, DL_SIDE = 60_000, 10_000, 10, 28
DL_KEEP_PIXELS = 717
DL_EPOCHS = 3.0
DL_PROFILE_ROWS, DL_PROFILE_EPOCHS = 2_000, (0.8, 2.4)   # 50, 150 steps
DL_PROFILE_PAUSE = 0.5
DL_CARD_TOL = 1e-4
PHASE32_WALLS: dict = {}


def make_mnist_like(n: int, seed: int):
    """An MNIST-shaped frame: `n` rows of 784 pixel columns C1..C784
    (integers in 0-255, row-major 28 x 28) and a 10-class `label`, the
    classes balanced. Pixels outside the DL_KEEP_PIXELS nearest the centre
    are zero in every row. Each class has a template of strokes (short
    random walks covering about a fifth of the kept pixels); a row turns
    on 70 % of its class template and 25 % of another class's (a
    confusable digit), both shifted by up to one pixel each way, and 3 %
    of the other kept pixels, at intensities in 64-255."""
    from h2o3_tpu_torch.frame.frame import Frame

    side = DL_SIDE
    r, c = np.divmod(np.arange(side * side), side)
    dist = np.hypot(r - (side - 1) / 2, c - (side - 1) / 2)
    keep = np.zeros(side * side, bool)
    keep[np.argsort(dist, kind="stable")[:DL_KEEP_PIXELS]] = True
    law = np.random.default_rng(1_000)
    templates = np.zeros((DL_CLASSES, side, side), bool)
    for k in range(DL_CLASSES):
        while templates[k].reshape(-1)[keep].mean() < 0.18:
            y0, x0 = law.integers(6, side - 6, 2)
            for dy, dx in law.integers(-1, 2, (24, 2)):
                y0, x0 = np.clip(y0 + dy, 3, side - 4), np.clip(x0 + dx, 3,
                                                                side - 4)
                templates[k, y0 - 1:y0 + 1, x0 - 1:x0 + 1] = True
    rng = np.random.default_rng(seed)
    label = rng.permutation(np.arange(n) % DL_CLASSES)
    other = (label + rng.integers(1, DL_CLASSES, n)) % DL_CLASSES
    shift = rng.integers(-1, 2, (n, 2))

    def strokes(cls, share):
        out = np.zeros((n, side * side), bool)
        for k in range(DL_CLASSES):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    rows = np.nonzero((cls == k) & (shift[:, 0] == dy)
                                      & (shift[:, 1] == dx))[0]
                    out[rows] = np.roll(templates[k], (dy, dx),
                                        axis=(0, 1)).reshape(-1)
        return out & (rng.random(out.shape, np.float32) < share)

    on = strokes(label, 0.7) | strokes(other, 0.25)
    on |= rng.random(on.shape, np.float32) < 0.03
    on &= keep
    px = np.where(on, rng.integers(64, 256, on.shape, np.uint8),
                  np.uint8(0))
    cols = {f"C{j + 1}": px[:, j] for j in range(side * side)}
    cols["label"] = label.astype(np.int64)
    return Frame.from_dict(cols, column_types={"label": "enum"})


def _dl_probs(frame) -> np.ndarray:
    return np.column_stack([np.asarray(frame.vec(n).data, np.float64)
                            for n in frame.names if n != "predict"])


def _dl_launches(dev, fr):
    """Per fit of DL_PROFILE_EPOCHS on `fr`, both under one torch.profiler
    session (a session costs seconds to start): (CUDA kernels, device busy
    µs, steps, step-loop s, kernels by name). The fits' device events part
    at the widest gap of the timeline, a pause of DL_PROFILE_PAUSE s made
    between them (a fit's own gaps are host work of milliseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from h2o3_tpu_torch.estimators import H2ODeepLearningEstimator

    # one chunk and one scoring event whatever the epochs
    ests = [H2ODeepLearningEstimator(epochs=e, seed=42, device=str(dev),
                                     train_samples_per_iteration=10 ** 9)
            for e in DL_PROFILE_EPOCHS]
    # the device's activity only: recording every host op of the steps
    # as well cost seconds a fit
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, est in enumerate(ests):
            if i:
                time.sleep(DL_PROFILE_PAUSE)
            est.train(y="label", training_frame=fr)
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    gaps = [events[j + 1].time_range.start - events[j].time_range.end
            for j in range(len(events) - 1)]
    cut = int(np.argmax(gaps)) + 1
    if gaps[cut - 1] < DL_PROFILE_PAUSE * 1e6 / 2:
        raise AssertionError("phase 32: the profiled fits' events do not "
                             "part at the pause")
    out = []
    for est, part in zip(ests, (events[:cut], events[cut:])):
        busy, end = 0.0, -math.inf
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in part):
            if b > end:
                busy += b - max(a, end)
                end = b
        out.append((len(part), busy, est.model.iterations,
                    est.model.fit_timings["steps_s"],
                    Counter(e.name[:60] for e in part)))
    return out


def dl_mnist_path(dev, card):
    """Phase 32 (a) and (c): the MNIST-shaped fit at full width; returns
    its record."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2ODeepLearningEstimator
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    tf32_off()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr, fv = make_mnist_like(DL_ROWS, 0), make_mnist_like(DL_VALID, 1)
    gen_s = time.perf_counter() - t0
    px = np.column_stack([np.asarray(fr.vec(f"C{j + 1}").data)
                          for j in range(DL_SIDE * DL_SIDE)])
    nonzero, varying = float((px > 0).mean()), int((px.max(0) > 0).sum())
    del px
    print(f"phase 32 frame (MNIST's shape): {DL_ROWS} + {DL_VALID} rows x "
          f"{DL_SIDE * DL_SIDE} pixels, {DL_CLASSES} classes, {varying} "
          f"pixels not constant, {nonzero * 100:.2f} % nonzero; generated "
          f"in {gen_s:.2f} s", flush=True)
    print(f"phase 32 cut: {DL_EPOCHS:g} epochs of the default 10; full "
          "width (hidden [200, 200], 717 inputs, mini-batch 32)", flush=True)
    bad = []
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    est = H2ODeepLearningEstimator(epochs=DL_EPOCHS, seed=42,
                                   device=str(dev))
    est.train(y="label", training_frame=fr, validation_frame=fv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = kernel_counts()
    m = est.model
    ft = m.fit_timings
    samples = m.iterations * 32
    yv = np.asarray(fv.vec("label").data)
    prior = float(np.log(DL_CLASSES))
    # launches and busy share a step: two short profiled fits differenced
    # (the design, the scoring event and the metrics cancel). A step's
    # work does not depend on the frame's rows, so they fit the first
    # DL_PROFILE_ROWS rows of the validation frame (all 717 pixels vary)
    t3 = time.perf_counter()
    small = fv.take(np.arange(DL_PROFILE_ROWS))
    prof = _dl_launches(dev, small)
    profile_s = time.perf_counter() - t3
    dk, db = prof[1][0] - prof[0][0], prof[1][1] - prof[0][1]
    dsteps = prof[1][2] - prof[0][2]
    per_step = {k: v / dsteps for k, v in (prof[1][4] - prof[0][4]).items()
                if v >= dsteps}
    step_ms = ft["steps_s"] / m.iterations * 1e3
    rec = dict(
        card=card, rows=DL_ROWS, valid_rows=DL_VALID, inputs=len(m.x),
        params=dict(hidden=[200, 200], epochs=DL_EPOCHS, mini_batch_size=32,
                    activation="Rectifier", adaptive_rate=True),
        wall_s=wall, fit_timings=ft, steps=m.iterations,
        samples_per_s=samples / wall,
        step_loop_samples_per_s=samples / ft["steps_s"], step_ms=step_ms,
        scoring_events=len(m.scoring_history),
        launches_per_step=dk / dsteps,
        device_us_per_step=db / dsteps,
        busy_share_of_step=db / dsteps / (step_ms * 1e3),
        profiled=[dict(epochs=e, kernels=k, busy_us=b, steps=st,
                       steps_s=ss) for e, (k, b, st, ss, _)
                  in zip(DL_PROFILE_EPOCHS, prof)], profile_s=profile_s,
        kernels_per_step=per_step,
        generator_s=gen_s,
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        train_logloss=float(m.logloss()), valid_logloss=float(
            m.logloss(valid=True)),
        valid_accuracy=float(m.validation_metrics.accuracy),
        prior_logloss=prior, kernel_counts=counts)
    print(f"phase 32(a) on {card}: fit {wall:.3f} s = pack "
          f"{ft['pack_s']:.3f} + H2D {ft['h2d_s']:.3f} + expand "
          f"{ft['expand_s']:.3f} + labels {ft['yw_h2d_s']:.3f} + init "
          f"{ft['init_s']:.3f} + steps {ft['steps_s']:.3f} + scoring "
          f"{ft['scoring_s']:.3f} + metrics {ft['metrics_s']:.3f}; "
          f"{m.iterations} steps, {rec['samples_per_s']:.1f} samples/s "
          f"({rec['step_loop_samples_per_s']:.1f} in the step loop, "
          f"{step_ms:.4f} ms a step), {rec['launches_per_step']:.2f} launches "
          f"and {rec['device_us_per_step']:.2f} device µs a step (busy "
          f"{rec['busy_share_of_step'] * 100:.2f} %); logloss "
          f"{rec['valid_logloss']:.6f} valid against the priors' "
          f"{prior:.6f}, accuracy {rec['valid_accuracy']:.4f}", flush=True)
    if any(counts.values()):
        bad.append(f"the DeepLearning fit launched a hand-written kernel: "
                   f"{counts}")
    if not (rec["valid_logloss"] < prior and rec["train_logloss"] < prior):
        bad.append("logloss not below the priors'")
    if m.iterations != -(-int(DL_EPOCHS * DL_ROWS) // 32):
        bad.append(f"{m.iterations} steps")

    # (c) predict against the MOJO, one served batch
    t2 = time.perf_counter()
    pred = m.predict(fv)
    predict_s = time.perf_counter() - t2
    probs = _dl_probs(pred)
    t4 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_dl_") as d:
        got = mojo.load_model(mojo.save_model(m, d, "dl.h2o3")).predict(fv)
    mojo_s = time.perf_counter() - t4
    mojo_err = float(np.abs(_dl_probs(got) - probs).max())
    engine = ScoringEngine(ServingConfig())
    try:
        batch = fv.take(np.arange(100, 357))
        served = engine.score("mnist_dl", m, batch)
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    serve_err = float(np.abs(_dl_probs(served)
                             - _dl_probs(m.predict(batch))).max())
    rec.update(predict_s=predict_s, mojo_s=mojo_s, mojo_max_abs_err=mojo_err,
               served_max_abs_err=serve_err,
               fallback_scores=snap["totals"]["fallback_scores"],
               predict_accuracy=float((np.asarray(pred.vec("predict").data)
                                       == yv).mean()))
    if not np.all(np.isfinite(probs)) or mojo_err > 1e-5:
        bad.append(f"predict non-finite or {mojo_err:.3e} from the MOJO")
    if serve_err > 1e-6 or snap["totals"]["fallback_scores"] \
            or snap["totals"]["errors"]:
        bad.append(f"served batch {serve_err:.3e} from predict, "
                   f"{snap['totals']}")
    print("phase 32 deeplearning mnist: " + json.dumps(rec), flush=True)
    PHASE32_WALLS["a_c"] = time.perf_counter() - t_phase
    tf32_off()
    if bad:
        raise AssertionError("phase 32(a, c): " + "; ".join(bad))
    return rec


def dl_small_frame(kind: str, n: int, seed: int):
    """The CPU tests' small frames (tests/test_torch_deeplearning.py):
    a binary label on 6 normals, a regression on them, weighted poisson
    counts, and the autoencoder's normals with five planted outliers."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(6)}
    if kind == "binomial":
        logit = X[:, 0] - 1.5 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
        cols["y"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
            np.int64)
        return Frame.from_dict(cols, column_types={"y": "enum"})
    if kind == "regression":
        cols["y"] = X[:, 0] - 2 * X[:, 1] + np.sin(X[:, 2]) \
            + 0.1 * rng.normal(size=n)
    elif kind == "poisson":
        cols["y"] = rng.poisson(np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1]))
        cols["w"] = rng.uniform(0.5, 2.0, n)
    else:
        X[:5] += 8.0
        cols = {f"x{i}": X[:, i] for i in range(6)}
    return Frame.from_dict(cols)


DL_SMALL_CASES = {
    "rectifier": ("binomial", dict(hidden=[32, 32])),
    "tanh": ("binomial", dict(hidden=[32], activation="Tanh")),
    "maxout": ("binomial", dict(hidden=[32], activation="Maxout",
                                input_dropout_ratio=0.1)),
    "rectifier_dropout": ("binomial", dict(
        hidden=[32, 16], activation="RectifierWithDropout",
        input_dropout_ratio=0.2, hidden_dropout_ratios=[0.3, 0.1])),
    "momentum_l1_l2": ("binomial", dict(
        hidden=[32], adaptive_rate=False, rate=0.01, momentum_start=0.5,
        momentum_stable=0.9, l1=1e-4, l2=1e-4)),
    "adadelta_max_w2": ("binomial", dict(hidden=[32], max_w2=2.0, l1=1e-3)),
    "regression": ("regression", dict(hidden=[32, 32])),
    "poisson": ("poisson", dict(hidden=[16], distribution="poisson",
                                weights_column="w")),
    "autoencoder": ("autoencoder", dict(autoencoder=True, hidden=[3])),
}


def dl_small_checks(dev, card):
    """Phase 32(b): card against CPU from the same seed on small frames:
    the draws bit for bit, predictions within DL_CARD_TOL, the
    autoencoder's `anomaly` on the card."""
    from h2o3_tpu_torch.estimators import H2ODeepLearningEstimator
    from h2o3_tpu_torch.models import deeplearning as dl
    from h2o3_tpu_torch.ops import prng

    tf32_off()
    t_phase = time.perf_counter()
    bad, out = [], {}
    # the draws: the initial weights, a chunk's permutation (two sort
    # rounds above 1625 rows) and one step's masks, card against CPU
    key = prng.split(prng.PRNGKey(42))[1]
    for sizes, act in (([717, 200, 200, 10], "Rectifier"),
                       ([6, 32, 2], "Maxout")):
        a, b = (dl._init_params(key, sizes, act, d) for d in (dev, "cpu"))
        if not all(torch.equal(x.cpu(), y) for p, q in zip(a, b)
                   for x, y in zip(p, q)):
            bad.append(f"initial weights of {sizes} differ")
    for n in (1200, DL_ROWS):
        if not torch.equal(prng.permutation(key, n, dev).cpu(),
                           prng.permutation(key, n, "cpu")):
            bad.append(f"the permutation of {n} rows differs")
    for ratio, shape in ((0.2, (128, 6)), (0.5, (32, 200)), (0.1, (32, 717))):
        sub = prng.split(key, 7)[3]
        if not torch.equal(prng.bernoulli(sub, 1 - ratio, shape, dev).cpu(),
                           prng.bernoulli(sub, 1 - ratio, shape, "cpu")):
            bad.append(f"the dropout mask {shape} at {ratio} differs")
    for name, (kind, params) in DL_SMALL_CASES.items():
        fr = dl_small_frame(kind, 1200, 7)
        params = dict(params, epochs=5, seed=5, mini_batch_size=128)
        kw = dict(x=fr.names) if kind == "autoencoder" else dict(y="y")
        fits = {}
        for d in (str(dev), "cpu"):
            est = H2ODeepLearningEstimator(device=d, **params)
            est.train(training_frame=fr, **kw)
            fits[d] = est.model
        a, b = fits[str(dev)], fits["cpu"]
        pa, pb = a.predict(fr), b.predict(fr)
        cols = [c for c in pa.names if c != "predict"] or ["predict"]
        diff = max(float(np.abs(np.asarray(pa.vec(c).data, np.float64)
                                - np.asarray(pb.vec(c).data,
                                             np.float64)).max())
                   for c in cols)
        rec = dict(max_predict_diff=diff, steps=a.iterations)
        if kind == "autoencoder":
            an = a.anomaly(fr).vec("Reconstruction.MSE").numeric_np()
            bn = b.anomaly(fr).vec("Reconstruction.MSE").numeric_np()
            rec["max_anomaly_diff"] = float(np.abs(an - bn).max())
            rec["planted_in_top8"] = int(len(set(np.argsort(-an)[:8])
                                             & set(range(5))))
            diff = max(diff, rec["max_anomaly_diff"])
        out[name] = rec
        if not diff <= DL_CARD_TOL:
            bad.append(f"{name}: card and CPU {diff:.3e} apart")
    PHASE32_WALLS["b"] = time.perf_counter() - t_phase
    print(f"phase 32(b) on {card}, card vs cpu (tolerance {DL_CARD_TOL}): "
          + json.dumps(out), flush=True)
    tf32_off()
    if bad:
        raise AssertionError("phase 32(b): " + "; ".join(bad))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda, shap_cuda

    # one nvcc per source, all started together
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=3) as ex:
        for f in [ex.submit(m.build) for m in (hist_cuda, score_cuda,
                                                shap_cuda)]:
            f.result()
    print(f"kernel build (hist.cu, score.cu and tree_shap.cu in parallel): "
          f"{time.time() - t0:.2f} s", flush=True)
    for m in (hist_cuda, score_cuda, shap_cuda):
        if m.build_log.strip():
            print(m.build_log.strip(), flush=True)

    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame

    rows, worst = kernel_vs_plain(dev)
    rec, fr, gbm_model = main_path(dev)
    small_reference_check(dev)
    profile_fit(H2OGradientBoostingEstimator(
        ntrees=PROFILE_TREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42, device=str(dev)), fr)
    rows_b2, worst_b2 = rows_vs_plain(dev)
    drf_rec, drf_model = drf_path(dev, fr)
    small_drf_check(dev)
    profile_fit(H2ORandomForestEstimator(
        ntrees=DRF_PROFILE_TREES, hist_method="pallas", seed=42,
        device=str(dev)), fr, tag="drf profile")
    del fr
    rows_sc, worst_sc = score_vs_plain(dev, {
        "gbm": (gbm_model.forest[0], gbm_model.max_depth),
        "drf": (drf_model.forest[0], drf_model.max_depth)})
    serve_rec = serve_path(dev, gbm_model)
    mojo_round_trip(dev, {"gbm": gbm_model, "drf": drf_model})
    # phases 20-23 explain phase 4's and phase 8's models while they live
    _, shap_entry = contributions_path(dev, gbm_model, drf_model)
    leaves_path(dev, gbm_model, drf_model)
    serve_explanations(dev, gbm_model)
    small_explain_checks(dev)
    del gbm_model, drf_model
    fr_cov, fv_cov = covtype_frames()
    multinomial_gbm_path(dev, fr_cov, fv_cov)
    profile_fit(H2OGradientBoostingEstimator(
        device=str(dev), **dict(COV_GBM, ntrees=COV_PROFILE_TREES)),
        fr_cov, tag="multinomial gbm profile", y="cover", valid=fv_cov)
    torch.cuda.reset_peak_memory_stats(dev)
    multinomial_drf_path(dev, fr_cov, fv_cov)
    # phase 30: the multinomial GLM, on the same frames
    multinomial_glm_path(dev, fr_cov, fv_cov)
    del fr_cov, fv_cov
    small_multinomial_glm_checks(dev, card_line())
    small_extension_checks(dev)
    fr_air, p_air, y_air = make_airlines_like(AIR_ROWS, 0)
    glm_rec = airlines_glm_path(dev, fr_air, p_air, y_air)
    fv_air, _, _ = make_airlines_like(AIR_VALID, 2)
    airlines_lambda_path(dev, fr_air, fv_air)
    # phase 31(d): gblinear on the same frame
    xgb_gblinear_path(dev, fr_air, glm_rec, card_line())
    del fr_air, fv_air
    small_glm_checks(dev)
    # phases 24-28: cross-validation and the stacked ensemble on phase 4's
    # frame, made again from its seed
    card = card_line()
    X, y = make_higgs_like(N_ROWS)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=[
        f"f{i}" for i in range(N_FEAT)] + ["label"]).asfactor("label")
    del X
    _, cv_ests = cv_tree_path(dev, fr, y, card)
    cv_glm_and_ensemble(dev, fr, cv_ests, card)
    del cv_ests
    # phase 31(b), (c) and (e): XGBoost on the same frame
    _, xgb1_model, b256 = xgb_automl_path(dev, fr, card)
    xgb_dart_path(dev, fr, xgb1_model, card)
    del fr, xgb1_model
    small_cv_checks(dev, card)
    # phase 29: 16-bit codes, on benchm-ml's Airlines GBM
    bm_recs, bm_codes, bm_passes = airlines_bm_path(dev, card)
    b16 = wide_kernels(dev, bm_codes, bm_passes)
    del bm_codes
    small_bm_checks(dev, card)
    # phase 31(a) and (f): lambdarank at MSLR-WEB30K's shape, card vs CPU
    xgb_rank_path(dev, card)
    xgb_small_checks(dev, card)
    print("phase 31 wall: " + json.dumps(dict(
        PHASE31_WALLS, total_s=sum(PHASE31_WALLS.values()))), flush=True)
    # phase 32: DeepLearning on an MNIST-shaped frame, then card vs CPU
    dl_mnist_path(dev, card)
    dl_small_checks(dev, card)
    print(f"phase 32 wall on {card}: " + json.dumps(dict(
        PHASE32_WALLS, total_s=sum(PHASE32_WALLS.values()))), flush=True)

    def total(passes, k):   # per tree: B2 widths weighted by passes per tree
        return sum(r[k] * r.get("per_tree", 1) for r in passes)

    kernels = [dict(
        name=name, route="cuda", source="h2o3_tpu_torch/csrc/hist.cu",
        replaces=replaces, launches=launches, max_abs_err=err,
        ms=total(passes, "ms"), plain_ms=total(passes, "plain_ms"),
        bound_ms=total(passes, "bound_ms"), bound_by="bytes",
        library_ms=total(passes, "library_ms"))
        for name, replaces, launches, err, passes in (
            ("hist_factored", "h2o3_tpu/ops/hist_pallas.py:103",
             rec["hist_launches"], worst, rows),
            ("hist_rows", "h2o3_tpu/ops/hist_pallas.py:174",
             drf_rec["hist_launches"], worst_b2, rows_b2))]
    # the scoring path's shape: phase 12's large request and phase 4's
    # predict, 100,000 rows through the GBM's forest; no single PyTorch
    # call walks a forest, so there is no library time
    at = next(r for r in rows_sc if r["forest"] == "gbm" and r["N"] == 100_000)
    kernels.append(dict(
        name="forest_score", route="cuda", source="h2o3_tpu_torch/csrc/score.cu",
        replaces="h2o3_tpu/models/tree.py:1057",
        launches=serve_rec["score_launches"], max_abs_err=worst_sc,
        ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
        bound_by="bytes", library_ms=None))
    # TreeSHAP: one call on phase 20's 100,000 rows through the GBM's 20
    # trees; no PyTorch call computes it, so there is no library time
    kernels.append(shap_entry)
    # the same two kernels on 16-bit codes: phase 29's trees
    for name, algo, count, replaces in (
            ("hist_factored_b16", "gbm", "b1_launches",
             "h2o3_tpu/ops/hist_pallas.py:103"),
            ("hist_rows_b16", "drf", "b2_launches",
             "h2o3_tpu/ops/hist_pallas.py:174")):
        t = b16[algo]
        kernels.append(dict(
            name=name, route="cuda", source="h2o3_tpu_torch/csrc/hist.cu",
            replaces=replaces, launches=bm_recs[algo][count],
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="bytes",
            library_ms=t["library_ms"]))
    # B1 at XGBoost's 256 bins: phase 31(c), the XGBoost_1 fit's codes
    kernels.append(b256)
    print(f"times are sums over passes at N={N_ROWS}, F={N_FEAT}, B={NBINS}: "
          f"hist_factored over one depth-6 tree's six (L = {LEVEL_WIDTHS}; "
          "uniform codes, L2 flushed; "
          f"{total(rows, 'fit_ms'):.4f} ms on the fit's own codes), "
          f"hist_rows over one DRF tree's {DRF_DEPTH + 1} + {DRF_DEPTH} passes "
          "(compact attempt and dense rebuild; uniform node law); "
          "forest_score is one call on 100,000 rows of the GBM's 20 trees "
          "(CUDA events, L2 flushed), its launches phase 12's; "
          "tree_shap is one call on 100,000 rows of the GBM's 20 trees "
          "(CUDA events), its bound the FP64 operations of shap_ops, its "
          "launches phase 20's; "
          f"hist_factored_b16 and hist_rows_b16 are one tree of phase 29's "
          f"GBM and DRF (N={BM_ROWS}, F=8, B={BM_NBINS}, int16 codes), each "
          "pass weighted by its count a tree (dense rebuilds averaged), "
          "their launches those fits'; "
          f"hist_factored_b256 is one depth-6 tree of phase 31(b)'s "
          f"XGBoost_1 (N={N_ROWS}, F={N_FEAT}, B={XGB_NBINS}, uint8 codes, "
          "L2 flushed), its launches that fit's; "
          "max_abs_err is against the f32 plain version (hist_factored also "
          "equals its fixed-point twin bit for bit)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
