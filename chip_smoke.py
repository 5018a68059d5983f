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
   holdout codes), then under `H2O3_CV_REBIN=1` (`build_bins` once a fold:
   the parent's bins come from the dataset cache the reuse-path fit filled;
   the same B1 launches; 2 x CV_FOLDS resident forest launches, a fold's
   holdout and its validation metrics). Each: xval AUC ≥ 0.75, a
   probability on every row, the fold sizes the reference's Random
   assignment gives, fold 0's rows equal to its model's own prediction of
   them. The two paths' xval AUC and logloss within 0.03 and their
   holdouts' mean |diff| < 0.05 (the reference's bars). Printed: the
   parent's and each fold's wall, `bins_s` and `trees_s`, beside the card.
25. The DRF of phase 8 with `nfolds=CV_FOLDS`, cut to CV_DRF_TREES trees
   from DRF_TREES (printed on a line of its own): B2 launched the passes of
   every fit's level plan plus its dense rebuilds, and nothing else; no
   `build_bins` (the parent's bins come from the dataset cache, the folds
   slice them); the holdout checks of phase 24.
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
   trees, B1 per level width; DART on the first DART_ROWS rows,
   DART_ROUNDS rounds at rate_drop DART_RATE, both normalize types (rounds
   rescaled, AUC), and skip_drop=1 at XGBoost_1's settings equal bit for
   bit to a gbtree fit of DART_ROUNDS trees at those settings on the same
   rows. (a) after phase 29: `rank:ndcg` on a generated
   frame of MSLR-WEB30K's shape (`make_mslr_like`, one fold's training
   part: 18,919 queries, 2,262,675 documents, 136 features; cut to
   1/MSLR_CUT of its queries and documents) at the
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

34. The unsupervised estimators, last, with no hand-written kernel. (a)
   K-Means on phase 14's Covertype-shaped predictors (581,012 × 54, k = 7,
   standardized, PlusPlus, ≤ 50 iterations): the fit's split (host
   matrix, seeding, H2D, the Lloyd loop and its iterations, metrics), the
   final WSS at or below the seeded centres', and one Lloyd step in f64
   on the host from the final centres: a fixed point (no centre moves by
   more than KM_FIXED_TOL) whose WSS is the model's within KM_WSS_TOL
   relative. (b) PCA (GramSVD and Randomized,
   STANDARDIZE) and SVD (GramSVD, keep_u) on phase 32's MNIST-shaped
   pixels (60,000 × 717 not constant, k = nv = 50): GramSVD's eigenvalues
   within PCA_EIG_TOL relative of an f64 eigh of an f64 Gram of the same
   matrix, its eigenpairs' residuals there within PCA_EIG_TOL·λ and its
   eigenvectors within PCA_EIG_TOL where Davis-Kahan (the card's f32 Gram
   error over the gap) allows it; Randomized's first 10 standard
   deviations within 2 % of GramSVD's; uᵀu within 1e-3 of I; every
   spectrum non-increasing. (c) GLRM (k = 10, STANDARDIZE) on a generated
   rank-10 frame of Covertype's shape with 10 % of its cells missing: the
   fit's split, the objective never rising between checks, the fit's RMSE
   on the observed cells at or below the generator's noise floor there
   (which the true factors reach), `reconstruct` on the missing cells
   within GLRM_FLOOR_MULT times that floor (its RMSE against the truth,
   noise included), `transform` on the card
   within 1e-4 of the reference's per-row loop on 2,000 rows. (d) Each
   model's MOJO against `predict` within 1e-5 on 2,000 rows (K-Means: the
   same clusters but for near-ties; GLRM's `transform` too), K-Means and
   PCA served equal to `predict` with no fallback. (e) Card against CPU
   on the CPU tests' small frames with their tolerances. (f) The launch
   counts, zeroed before (a), read after (e): none of B1, B2, the forest
   scorer or TreeSHAP ran. TF32 stays off. The phase's wall is printed.

35. The isolation forests and the uplift DRF, last. (a) IsolationForest
   at its defaults (50 trees, sample_size 256, depth 8) and (b)
   ExtendedIsolationForest at its defaults (100 trees, sample_size 256)
   at extension_level 0 and 29 (= p − 1) on a generated frame of the ULB
   credit-card-fraud dataset's shape (284,807 × 30: Time, V1–V28,
   Amount; 492 planted frauds), and at 27 on V1–V28 alone: each fit's
   split and `predict`'s wall on all rows; the frauds' mean score above
   the rest's by IF_GAP and more than IF_TOP of them in the top 5 % (the
   reference's bars), but at 29 on all columns, where Time's scale fills
   every oblique projection (printed, not held). (c) UpliftDRF at its
   defaults (50 trees, depth 10, nbins 20 → B = 32, KL, sample_rate
   0.632, mtries −2) on a generated frame of the Criteo Uplift v2.1
   shape (12 features, treatment 85 %, visit ≈4.7 %, a known uplift on a
   region), cut to UP_ROWS of its 13,979,592 rows: the fit's split
   (binning, upload, tree loop, metrics); B1 launched exactly 2 × 11 × 50
   times, B2 never, the forest scorer once for the training metrics and
   once per `predict`; tree 0's deepest pass (L = 1024, the sampled
   treatment weights) bit-equal to `hist_plain_fixed`, its 22 passes
   timed against the bytes bound, the plain version and `index_add_`;
   one tree built again under the profiler (its launches, the device's
   busy share); each tree's root value within UP_ROOT_TOL of p_t − p_c of
   its sampled rows in f64 on the host; the mean predicted uplift on the
   region above the rest's and the qini AUUC above a random ranking's
   (the reference's bars). (d) Each model's MOJO against `predict` on
   UP_CHECK_ROWS rows within 1e-5, but for rows within one f32 rounding
   of a threshold (counted and printed), no kernel launched by a MOJO
   scorer; one batch of each served equal to `predict` with no fallback.
   (e) Card against CPU on the CPU tests' small frames (IF_SMALL_TOLS),
   and UpliftDRF at nbins 300 (B = 512: uint16 codes sent as int16, B1's
   int16 instance) with its forest equal to the CPU's node for node.
   (f) The launch counts, zeroed before (a), read after (a, b) (none)
   and after (e) (no B2 and no TreeSHAP). The phase's wall is printed.

36. NaiveBayes, GAM, isotonic regression, ANOVA GLM and ModelSelection,
   last, TF32 off. (a) NaiveBayes at its defaults on phase 14's
   Covertype-shaped frame (581,012 rows; the 10 continuous columns
   numeric, the wilderness area and soil type as enums of 4 and 40
   levels): the fit's split (host tables, device moments, metrics) and
   `predict`'s wall; the priors equal bincount / n, each class mean within
   NB_MEAN_TOL relative of an f64 two-pass mean, each sd's largest
   relative gap from the f64 two-pass sd printed (the reference's one-pass
   f32 variance, ROADMAP §C), the tables bit-equal to a host recount, the
   training logloss below the priors', a second fit bit-equal. (b) A
   binomial GAM (DepTime and Distance as splines of 10 knots; Origin,
   Dest, Month and DayOfWeek linear) on GAM_ROWS rows of
   `make_airlines_gam_like` (config 2's Airlines shape with a smooth
   afternoon bump in DepTime): the fit's split, its IRLS iterations and
   each Gram's ms; the IRLS stopped on beta_epsilon; the holdout AUC
   (GAM_HOLDOUT rows) within GAM_AUC_TOL of the generator's and above a
   linear GLM's by GAM_GLM_MARGIN. (c) Isotonic regression calibrating
   (b)'s holdout probabilities against its labels, "clip" and "NA": knots
   rising, each pool's value its rows' mean within 1e-12, the
   out-of-range rules. (d) ANOVA GLM (binomial, interactions of 2) on
   DepTime, DayOfWeek and Month of (b)'s frame cut to ANOVA_ROWS: each
   GLM fit's wall (each pays the GLM's host pack, ROADMAP A5f), each
   term's df its column count, every deviance finite and ≥ 0, DepTime
   and DayOfWeek at p < 1e-6. (e) ModelSelection
   (maxr, gaussian, up to 7 predictors) on MS_ROWS rows of the prostate
   columns of H2O's ModelSelection example: the number of GLM fits and
   the wall; each size's R² within MS_R2_TOL of a host f64 least-squares
   R², sizes 1-3 of the exhaustive best subset's; the three true
   predictors first. (f) The MOJOs of NaiveBayes, isotonic and GAM
   against `predict`; ANOVA GLM and ModelSelection refuse export; one
   batch of each of the five served equal to `predict` with no fallback.
   (g) Card against CPU on the CPU tests' small frames (SMALL36_TOLS).
   (h) The launch counts, zeroed before (a), read after (g): none. The
   phase's wall and the smoke's are printed.
37. CoxPH, PSVM and RuleFit at full width, TF32 off. (a) CoxPH on
   HEART_ROWS counting-process rows with the columns of H2O's CoxPH
   example (the Stanford heart transplant data: start, stop, event, age,
   year, surgery, transplant; `make_heart_like`, a known β, whole-day
   times), fitted as the example calls it (start and stop columns,
   Breslow) and again with Efron stratified by surgery: the fit's split
   (host sort and tie groups, Newton's iterations and ms each, the
   concordance), Newton stopped on max|step| < 1e-8, the score vector at
   β from an independent host f64 evaluation within 1e-6 × the events,
   loglik above the null's, standard errors > 0, the Efron β within
   HEART_SE_BAR standard errors of the generator's, a tie group of d > 1
   events, the Breslow gap printed, and the concordance counts on a
   CONC_CHECK_ROWS slice equal to the reference's loop's. (b) PSVM as
   H2O's PSVM example calls it (gamma 0.01, rank_ratio 0.1) on
   SPLICE_ROWS rows of the splice data's shape (60 positions of four
   values; D = 10,000 Fourier features, Z 4 GB f32 on the card), and the
   linear kernel: W and b bit-equal to a host draw, Z within
   4e-6·√(2/D) of a host f64 recompute and `decision_function` within
   1e-6 of the host's on CHECK37_ROWS rows, the linear fit's Adam stopped
   on its rule and the gaussian's stopped, or ran the reference's bound of
   1000 steps still descending (as the reference does on this frame), the
   gaussian AUC above the linear one's by PSVM_AUC_MARGIN. (c)
   RuleFit at its defaults with `max_num_rules=100` (H2O's RuleFit
   example) on RF37_ROWS + RF37_HOLDOUT HIGGS-shaped rows: the split
   (tree fits, rule counts, evaluation, feature frame, the GLM path and
   its host pack's share), every kept rule's column and support equal to
   the host's, at most 100 active rules, the holdout AUC above a lasso
   GLM's on the linear terms alone by RF_AUC_MARGIN, B1 launched and
   counted, B2 not. (d) CoxPH's and RuleFit's MOJOs against `predict`;
   PSVM refuses export; one batch of each served equal to `predict` with
   no fallback. (e) Card against CPU on the CPU tests' small frames
   (SMALL37_TOLS), with a 3-fold CV of CoxPH and PSVM and an
   RF_SMALL_FOLDS-fold CV of RuleFit under the GBM (its pairs cut to
   RF_SMALL_TREES trees).
   (f) The launch counts, zeroed before (a): none after (a, b); after (e)
   B1 alone. The phase's wall is printed.
38. The rest of the port's estimators at full width, TF32 off. (a)
   TargetEncoder with the parameters of H2O's target-encoding user-guide
   example (KFold on a 5-value fold column, blending, inflection point 3,
   smoothing 10, noise 0.15, seed 1234) on Origin and Dest of a
   TE_ROWS-row Airlines-shaped frame (phase 36's generator): the fit's and
   both transforms' walls and splits, the card's per-level sums, counts
   and out-of-fold tables equal to a host `np.add.at` bit for bit; phase
   4's GBM on DepTime, Distance and the two encodings, on the raw enums and
   on DepTime and Distance alone, each fit B1 alone (NTREES x DEPTH
   launches): holdout AUCs on TE_HOLDOUT fresh rows, the encodings' within
   TE_RAW_TOL below the raw enums'. (b) Word2Vec at its defaults (W2V38) on a text8-shaped
   stream (`make_text8_like`: W2V_TOKENS tokens cut from text8's
   17,005,207, a Zipf law of W2V_TYPES words, sentences broken by NAs,
   W2V_GROUPS planted topic groups): vocabulary, pairs, steps, ms a step,
   kernels and device ms a step from a profiled replay of the step and the
   device's busy share; every planted word's top synonym in its group; the
   AVERAGE transform one row per sentence. (c) Aggregator at its defaults
   on phase 14's Covertype frame cut to AGG_ROWS (the reference's
   envelope): passes, exemplars, the walls of the device block pass and
   the host loop; the counts summing to the rows, the exemplars within the
   target's tolerance, AGG_CHECK_ROWS sampled non-exemplar rows each within
   the final radius of an exemplar in f64. (d) The quantiles op on phase
   4's first HIGGS column and a weighted column with NaNs: within one
   final-refinement bin plus f32 spacing of the weighted f64 inverse CDF,
   and with unit weights equal to the CPU bit for bit. (e) XGBoost with
   grow_policy="lossguide", max_leaves 31, depth 6 and XGBoost_1's other
   settings on phase 4's frame: the fit's wall and trees a second, B1
   launched once a tree and once a split and nothing else, no tree over 31
   leaves, the holdout AUC within LG_AUC_TOL of phase 31(b)'s XGBoost_1;
   tree 0's passes as they ran replayed through B1 (bit-equal to
   `hist_plain_fixed`), timed against the bytes bound, the plain version
   and one `index_add_` (the hist_factored_lossguide row of the kernel
   table). (f) The MOJOs: TargetEncoder's columns and Word2Vec's vectors,
   synonyms and transforms equal to the model's, the lossguide forest
   within 1e-6 of `predict`, the Aggregator's export a `TypeError`. (g)
   Card against CPU on the CPU tests' small frames (SMALL38_TOLS). (h) The
   launch counts of each path: none but for (a)'s GBMs and (e), B1 alone.
   The phase's wall is printed.
39. The dataset cache and the out-of-core tree path (the block store, its
   disk tier, the streamed GBM/DRF step and GOSS). (a) A streamed GBM
   (`H2O3_TREE_OOC=1`, a stream budget of a quarter of the packed codes,
   S = 16)
   on config 1's HIGGS shape cut to OOC_ROWS of its 11,000,000 rows (the
   cut printed), binomial, depth 6, UniformAdaptive, 20 trees: S, the
   streamed bytes, the store's resident peak (within the budget), the
   fit's device peak, B1 launched 20 x 6 x S times and nothing else, the
   holdout AUC on OOC_HOLDOUT fresh rows. (b) The blocks lane at that S
   (`H2O3_TREE_OOC=0 H2O3_TREE_SHARD=1 H2O3_TREE_SHARD_BLOCKS=S`) on the
   same frame: forest, varimp, scoring history and `predict` equal to (a)
   bit for bit; it hits the cache's matrix and bins layers (it does not
   bin again); its device peak above (a)'s. (c) GOSS (rates 0.2 and 0.1)
   on (a)'s frame and budget, twice: fewer bytes streamed than (a), the
   two forests equal, the holdout AUC within OOC_GOSS_AUC_TOL of (a)'s.
   (d) OOC_SMALL of the rows, 5 trees, a host budget of a third of the
   packed codes and a stream budget of a quarter (blocks spill to disk and
   are read back every level): the forest equal to the
   blocks lane's at its S; the spilled and restored bytes; after the
   cache closes the store, its spill directory is empty and the ledger
   shows no leak. (e) A streamed DRF on B2 (`hist_method="pallas"`, depth
   12, sample rate 0.632, mtries, OOB) on those rows: its forest equal to
   the blocks lane's; B2 launched 5 x 12 x S times and nothing else. (f) A
   random grid of three GBMs with the cache and without it: the forests
   equal, the second and third candidates hitting the matrix, bins and
   device layers; then a GLM, K-Means and PCA on the same predictors: PCA
   takes K-Means's host and device artifacts from the std layer. (g) A
   streamed GBM at S = 4 (a seeded weights column: every row reaches the
   same leaf) and a streamed DRF (0/1 sums: the same forest), card against
   CPU on phase 5's fixture. Then B1 over one block of (a)'s codes at each
   of a depth-6 tree's passes and B2 over one block of (e)'s at each of a
   depth-12 tree's (bit-equal to `hist_plain_fixed` and within rtol 1e-5
   of their plain versions, timed with the L2 flushed beside the plain
   versions, one `index_add_` and the bytes bound: the
   hist_factored_stream and hist_rows_stream rows of the kernel table).
   The phase's walls are printed.
40. The multi-process tree lane: ranks started as fresh interpreters
   through `python -m h2o3_tpu_torch.parallel.launcher` (this script with
   `--pod-rank`, after the kernels are built), rendezvousing through a
   FileStore in a temporary directory and sharing the card over gloo; each
   rank draws phase 39's frame, keeps only its own ingest rows (uneven
   shards) and fits; every leg must equal this process's own blocks-lane
   fit at S = 8 (`H2O3_TREE_SHARD=1`) bit for bit: forest, varimp,
   scoring history, tree count, and each rank's `predict` on its ingest
   rows against the same rows of the one-process `predict`. (a) Two ranks
   (rows [0, 499,993) and the rest of POD_ROWS of config 1's 11,000,000),
   the depth-6 UniformAdaptive GBM of 20 trees with a scoring interval of
   5 and a stopper: B1 launched trees x 6 x 4 times a rank and nothing
   else, each rank's device peak (the allocator's, over its fit) at most
   0.75x the one-process fit's; the gathers (count, bytes, seconds). (b)
   The same ranks and frame, a depth-12 DRF of 5 trees on B2 (sample rate
   0.632, mtries, out-of-bag events every tree): B2 trees x 12 x 4 a rank.
   (c) Four ranks on POD_QG_ROWS of the rows, a QuantilesGlobal GBM of 10
   trees (edges from the global quantile collective): B1 trees x 6 x 2 a
   rank. (d) Where the host shows two cards, (a) again with one card a
   rank over NCCL; else a line says it did not run. (e)-(g) The estimator
   engine on (a)'s ranks, after (a) and (b), each against this process's
   blocks-lane fit at S = 8 (`H2O3_EST_SHARD=1`; (g) with
   `H2O3_TREE_SHARD=1` and `H2O3_CV_REBIN=1`): (e) config 2's Airlines
   logistic GLM (217 slopes and the intercept) with p-values and 3 folds
   on POD_AIR_ROWS of phase 17's generator, β, standard errors, p-values,
   fold β, holdout rows and CV metrics within POD_EST_TOL, no hand-written
   kernel; (f) K-Means at UNSUP_KM and a GramSVD PCA at k = UNSUP_PCA_K
   (DEMEAN) on POD_COV_ROWS of phase 34's Covertype-shaped predictors,
   within UNSUP_SMALL_TOLS, no hand-written kernel, the bytes each rank's
   whole-matrix gathers held printed; (g) (a)'s GBM with 3 folds on
   POD_CV_ROWS of the rows, fold forests, holdout rows and CV metrics bit
   for bit, B1 (Σ trees of the parent and its folds) x 6 x 4 a rank.
   (h)-(j) on the same ranks after (g), against this process's blocks-lane
   fits at S = 8, no hand-written kernel: (h) phase 18's λ search (30 λ,
   α 0.5) on (e)'s rows with a validation frame of POD_AIR_VALID more
   generated rows split unevenly over the ranks, the λ list, λ_best, each
   λ's deviance and β within POD_EST_TOL; (i) phase 30's 7-class GLM on
   (f)'s rows and their labels, centred β and each rank's probabilities
   within the CPU tests' bars; (j) K-Means from POD_KM_POINTS seeded rows
   of (f)'s frame (unstandardized) and, on phase 34's MNIST-shaped pixels,
   PCA Randomized (DEMEAN) and SVD with keep_u (GramSVD and Randomized at
   nv = UNSUP_PCA_K, Power at POD_POWER_NV), bit for bit: centres, WSS,
   iterations, eigenpairs, d, v and each rank's rows of u. Each leg prints
   its fits' walls and splits and each rank's gathers (count, bytes,
   seconds). Every wall is printed beside the card's name and power limit;
   any child left is killed.
41. The GBM/DRF class and constraint parameters (`tree_params_path`). (a)
   Phase 4's HIGGS GBM (1M x 28, depth 6, 20 trees, UniformAdaptive) with
   a +1 constraint on f0 and a -1 on f1: B1 launched 20 x 6 times and
   nothing else, no constrained split out of order in any tree
   (`tree.monotone_violations`), no violation in a 64-point sweep of each
   constrained column over 1,000 holdout rows, holdout AUC >= 0.75 beside
   phase 4's, wall and trees/s. (b) The ULB credit-card shape (284,807 x
   30) with its label drawn from a known logistic of four V columns, the
   intercept set for exactly 492 positives, split train / calibration /
   holdout: a balanced GBM with Platt scaling, then one with isotonic
   regression: the weights equal to a host recount bit for bit, the prior
   correction to the host f64 formula within 1e-12, (a, b) to a host f64
   Newton within 1e-10, the knots to host `pav` bit for bit, the calibrated
   holdout logloss within CC41_LOGLOSS_TOL of the raw one, a served batch
   and a forced failover batch equal to `predict` within 1e-6 (`cal_`
   columns included), the MOJO's gap printed. (c) A DRF with
   `sample_rate_per_class=[0.1, 1.0]` on the same frame: the fit's row
   rates equal to rates[y], B2 the plan's passes and nothing else,
   out-of-bag and holdout AUC beside the generator's against
   CC41_DRF_FLOORS. (d) (a)-(c) at P41_SMALL rows, card against CPU.

Each path is driven with every launch count set to 0 just before it and
read just after (phase 12 is the scoring path's own; phases 14 and 15 zero
them again before their `predict`; phase 20 is the TreeSHAP path's; phases
24, 25 and 27's `predict` are the CV path's; phase 29's fits are each
their own; phase 30's stack `predict` is its own; each of phase 31's
fits, its `predict` and its contributions are their own; the GLM and
gblinear run none of the hand-written kernels, and phases 17, 18, 26, 30
and 31(d) fail if they launched one; so does phase 32's DeepLearning
fit, and phase 34 as a whole; phase 35's fits and `predict`s count
their own launches, and its isolation forests fail if they launched
one; so does phase 36 as a whole, and phase 37's CoxPH and PSVM, and phase
38's encoder, Word2Vec, Aggregator and quantiles; phase 39's fits count
their own, and so do phase 40's, in each rank's process, and phase 41's).
TF32 must stay off
through phases 17-19, 30, 31(d), 32, 36, 37 and 38. The last line is
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
# the DRF's 2,500 explained rows, cut from 100,000 (10,000 before phase 38
# came in): path-dependent TreeSHAP on its 50 trees of depth 19 costs
# ~10^9 FP64 operations a row, ≈0.9 ms a row of kernel time on an H100
# (PERF.md §5), and phase 20 runs the DRF's rows through the kernel three
# times
SHAP_DRF_ROWS, SHAP_DRF_CUT_FROM = 2_500, 100_000
# the DRF's first rows also timed alone: the size at which the kernel's
# earlier design was measured (PERF.md §6), and one at which a tree's warps
# set the call's time
SHAP_DRF_SHORT_ROWS = 1_000
SHAP_PLAIN_ROWS = 512
# the DRF's rows that its slice of one depth-19 tree explains, kernel
# against plain on the CPU (~1.5 ms of host time a leaf, ~22,600 leaves):
# 8, cut from 32 to make room for phase 39 (the 32 rows took 11.1 s of
# host on an H100's host)
SHAP_SLICE_ROWS, SHAP_SLICE_FROM = 8, 32
# phase 21's rows per forest: 25,000, cut from 100,000 to make room for
# phase 39 (the DRF's Path strings and the CPU's walk scale with the rows)
LEAF_ROWS, LEAF_ROWS_FROM = 25_000, 100_000
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
          f"from {SHAP_DRF_CUT_FROM}; its depth-19 tree's CPU slice "
          f"{SHAP_SLICE_ROWS} rows, reduced from {SHAP_SLICE_FROM}",
          flush=True)
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
    print(f"phase 21 cut: {LEAF_ROWS} rows a forest, reduced from "
          f"{LEAF_ROWS_FROM}", flush=True)
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
# frame. The folds are cut to 2 from the reference's 5 to make room for
# phase 38 (each cut is printed on its phase's line). The DRF's CV is cut
# to CV_DRF_TREES trees from DRF_TREES: its 10-tree fits took 0.29 s a
# tree on an H100, so three 50-tree fits would add ≈40 s
CV_FOLDS, CV_DRF_TREES, CV_SMALL_FOLDS = 2, 5, 3
CV_FOLDS_FROM = 5
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
    """Phases 24-25: the CV_FOLDS-fold GBM on both fold paths and the
    CV_FOLDS-fold CV_DRF_TREES-tree DRF; returns their records and
    estimators."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    cv = dict(nfolds=CV_FOLDS, keep_cross_validation_predictions=True,
              seed=42, device=str(dev))
    out, ests, bad = {}, {}, []
    print(f"phase 24 cut: {CV_FOLDS} folds, reduced from {CV_FOLDS_FROM} "
          "(phases 24-28)", flush=True)
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
        # the rebin parent's bins come from the dataset cache, which the
        # reuse-path parent filled on this frame
        bins_expect = 1 if path == "reuse" else CV_FOLDS
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
          f"reduced from {DRF_TREES}, and {CV_FOLDS} folds of "
          f"{CV_FOLDS_FROM}", flush=True)
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
    # the parent's bins come from the dataset cache (the GBMs' on this
    # frame), and its folds slice them
    if rec["build_bins_calls"] != 0 or rec["score_launches"]:
        bad.append(f"drf: build_bins {rec['build_bins_calls']}, forest "
                   f"launches {rec['score_launches']}; expected 0 and 0")
    if rec["xval_auc"] < DRF_AUC_FLOOR - 0.05:
        bad.append(f"drf: xval AUC {rec['xval_auc']} too low")
    _check_holdout(drf, fr, y_np, CV_FOLDS, 42, bad, "drf")
    if bad:
        raise AssertionError("; ".join(bad))
    return out, ests


def cv_glm_and_ensemble(dev, fr, ests, card):
    """Phases 26-27: the CV_FOLDS-fold binomial GLM, then the stacked ensemble of
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
# without early stopping; both base models have MN_FOLDS folds and are
# fitted on the frame's first MN_CV_ROWS rows, to make room for phase 38:
# their CV fits pay the host pack and the binning of every row
MN_GLM = dict(family="multinomial", alpha=0.0, lambda_=1e-5)
MN_FOLDS, MN_GBM_TREES, MN_CV_ROWS = 2, 10, 200_000
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

    # MN_FOLDS-fold CV of the same GLM on the first MN_CV_ROWS rows, the
    # holdout kept for the stack
    print(f"phase 30 cut: the CV GLM and the stack fit the first "
          f"{MN_CV_ROWS} of the frame's {N} rows, {MN_FOLDS} folds a base "
          f"model; the stack's GBM fits {MN_GBM_TREES} "
          f"trees a class, reduced from COV_GBM's {COV_GBM['ntrees']}, "
          "without early stopping", flush=True)
    fr_cv = fr.take(np.arange(MN_CV_ROWS))
    cv_glm = H2OGeneralizedLinearEstimator(
        device=str(dev), nfolds=MN_FOLDS, seed=42,
        keep_cross_validation_predictions=True, **MN_GLM)
    zero_counts()
    t5 = time.perf_counter()
    cv_glm.train(y="cover", training_frame=fr_cv)
    torch.cuda.synchronize()
    cv_wall = time.perf_counter() - t5
    cv_counts = kernel_counts()
    ho = cv_glm.model._cv_holdout_pred
    cv_rec = dict(card=card, rows=MN_CV_ROWS, folds=MN_FOLDS, wall_s=cv_wall,
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
    if ho is None or ho.shape != (MN_CV_ROWS, COV_K) \
            or not np.all(np.isfinite(ho)) \
            or float(np.abs(ho.sum(1) - 1).max()) > 1e-5:
        bad.append("cv glm: holdout missing, non-finite or rows off 1")
    if any(cv_counts.values()):
        bad.append(f"the GLM's CV launched a hand-written kernel: {cv_counts}")

    # the multiclass stack: the CV GLM and a MN_FOLDS-fold 7-class GBM
    gbm = H2OGradientBoostingEstimator(
        device=str(dev), nfolds=MN_FOLDS, keep_cross_validation_predictions=True,
        **dict(COV_GBM, ntrees=MN_GBM_TREES, stopping_rounds=0))
    zero_counts()
    t6 = time.perf_counter()
    gbm.train(y="cover", training_frame=fr_cv)
    torch.cuda.synchronize()
    gbm_wall = time.perf_counter() - t6
    gbm_b1 = hist_cuda.launches
    se = H2OStackedEnsembleEstimator(base_models=[gbm, cv_glm],
                                     device=str(dev))
    t7 = time.perf_counter()
    se.train(y="cover", training_frame=fr_cv)
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
# the smoke fits an eighth of the fold's queries and documents (a half
# before phase 38 came in), to leave the later phases their time (the shape
# of a query, the features and the labels are kept)
MSLR_CUT = 8
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
# DART fits the first DART_ROWS of phase 4's rows: each fit's 256-bin
# binning of all 1,000,000 rows was 5.8 s of its 7 s on an H100
DART_ROUNDS, DART_RATE, DART_ROWS = 20, 0.1, 250_000
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
    Q, N = MSLR_TRAIN_QUERIES // MSLR_CUT, MSLR_TRAIN_DOCS // MSLR_CUT
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
    print(f"phase 31(a) cut: 1/{MSLR_CUT} of the fold's {MSLR_TRAIN_QUERIES} "
          f"queries and {MSLR_TRAIN_DOCS} documents ({XGB_TREES} trees, "
          "bench.py's count)", flush=True)
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
    holdout_auc = _auc(yt, p1)
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
                       holdout_auc=holdout_auc,
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


def xgb_dart_path(dev, fr, card):
    """Phase 31(e): DART on the first DART_ROWS rows of phase 4's frame,
    DART_ROUNDS rounds at rate_drop DART_RATE, both normalize types;
    skip_drop=1 at XGBoost_1's settings equals a gbtree fit of DART_ROUNDS
    trees at those settings on the same rows bit for bit."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    t_phase = time.perf_counter()
    print(f"phase 31(e) cut: DART and its gbtree twin fit the first "
          f"{DART_ROWS} of phase 4's {fr.nrow} rows", flush=True)
    fr = fr.take(np.arange(DART_ROWS))
    rec, bad = dict(rows=DART_ROWS), []
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
    a, b = (H2OXGBoostEstimator(seed=42, device=str(dev),
                                **dict(XGB_1, ntrees=DART_ROUNDS), **kw)
            .train(y="label", training_frame=fr).model.forest[0]
            for kw in (dict(booster="dart", rate_drop=DART_RATE,
                            skip_drop=1.0), {}))
    same = all(torch.equal(fa, fb) for fa, fb in zip(a, b))
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
# estimator's default 10 (to 3, then to 1 for phase 38's room) to keep the
# smoke's wall (tools/dl_mnist.py runs the default); the width is the
# default's
DL_ROWS, DL_VALID, DL_CLASSES, DL_SIDE = 60_000, 10_000, 10, 28
DL_KEEP_PIXELS = 717
DL_EPOCHS = 1.0
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
    # as well cost seconds a fit. The dataset cache is off, so both fits
    # build their design and it cancels in the difference
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            mock.patch.dict(os.environ, {"H2O3_DATASET_CACHE": "0"}):
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


# phase 33: AutoML and grid search, BASELINE.json config 5 ("H2OAutoML full
# leaderboard (GBM/DRF/GLM/DeepLearning/StackedEnsemble)") on the
# HIGGS-shaped frame of phase 4 (28 features, a binary label; cut in rows).
# (a) runs the reference's whole modeling plan through the train pool on
# the card: XGBoost_1-3, GLM_1, DRF_1, XRT_1, GBM_1-5, DeepLearning_1-3,
# the GBM, XGBoost and DeepLearning random grids (three models each) and
# both stacked ensembles, every base model with AML_FOLDS-fold CV
# (`tools/automl_higgs.py` runs the same at 100,000 rows). (b) holds a
# `max_models=AML_SMALL_MODELS`, 2-fold AutoML and a RandomDiscrete grid of
# three GBMs on AML_SMALL_ROWS rows to the CPU, and `parallelism=2` to 1 on
# the card.
# cut to 2 folds from the reference's 5 to keep the smoke's time
# (tools/automl_higgs.py runs 5), and to 2,500 rows of HIGGS' 11,000,000
# (5,000 before phase 40 took its room; the whole plan still runs)
AML_ROWS, AML_FOLDS, AML_SEED = 2_500, 2, 42
AML_SMALL_ROWS = 2_000
# 33(b)'s AutoML: 3 base models (XGBoost_1-3) and the AllModels stack (one
# family, so no BestOfFamily stack), cut from 6 (with GLM_1, DRF_1 and
# XRT_1, 8 models with both stacks) to make room for phase 37 (PERF.md §4)
AML_SMALL_MODELS, AML_SMALL_BUILT = 3, 4
# card vs CPU, the largest difference of a row's CV AUC, logloss and RMSE,
# by step (the largest reading on an H100 in brackets; the CPU's GLM sums
# depend on its thread count, so GLM_1's and the stacks' readings move
# with AML_CPU_THREADS): B1's fixed-point sums break the near-tied gains
# of 1,000-row folds at XGBoost's 256 bins otherwise than the CPU's f32
# sums, so the XGBoost rows' trees part (2.41e-2; tests/test_torch_automl.py
# sees the same between the packages), and the stacks on them (3.48e-3);
# the histogram budget clamps DRF_1's and XRT_1's depth 20 to 19 on the
# card and to 17 on the CPU (`shared_tree._histogram_budget`), so their
# forests differ by design (5.18e-4); GLM_1's λ path (1.2e-5 on two CPU
# threads, 1.8e-6 on four; the GLM card bar of β within 1e-4)
AML_TOLS = (("XGBoost", 3e-2), ("StackedEnsemble", 1e-2), ("DRF", 1e-3),
            ("XRT", 1e-3), ("GLM", 1e-4))
# the rows whose fits agree: their CV holdout predictions too (GLM_1
# 1.62e-4 on two CPU threads, 1.27e-4 on four: its β within 1e-4 moves a
# probability by more)
AML_HOLDOUT_TOLS = (("GLM", 5e-4),)
# the grid's GBMs: training AUC and logloss (6.1e-8) and the predictions
# on the frame (1.3e-6)
AML_GRID_TOL = 1e-5
AML_GRID = dict(max_depth=[2, 3, 4, 5], learn_rate=[0.05, 0.1, 0.2, 0.3])
AML_TREE_ALGOS = ("gbm", "drf", "xgboost")
PHASE33_WALLS: dict = {}


def automl_frame(rows: int, seed: int):
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(rows, seed=seed)
    return Frame.from_numpy(np.column_stack([X, y]), names=[
        f"f{i}" for i in range(N_FEAT)] + ["label"]).asfactor("label")


def automl_names(aml) -> list:
    """The AutoML step name of each leaderboard row, in its order."""
    return [getattr(r["_est"], "_automl_name", r["model_id"])
            for r in aml.leaderboard.rows]


def automl_family(name: str) -> str:
    head = name.split("_")[0]
    head = {"XGBOOST": "XGBoost", "DEEPLEARNING": "DeepLearning"}.get(
        head, head)
    return head + (" grid" if "_grid_" in name else "")


def automl_plan_names(aml) -> list:
    """Every base model of the full plan and both ensembles."""
    steps = [s["name"] for s in aml._steps("binomial")]
    grids = [f"{g}_grid_1_model_{i}" for g in ("GBM", "XGBOOST",
                                               "DEEPLEARNING")
             for i in (1, 2, 3)]
    return steps + grids + ["StackedEnsemble_BestOfFamily",
                            "StackedEnsemble_AllModels"]


def automl_candidate_memory(dev, mem: dict):
    """A stand-in for `H2OAutoML._candidate` that records the device bytes
    each candidate leaves allocated against its model's own: fold models
    that were not freed (keep_cross_validation_models=False) would show."""
    from h2o3_tpu_torch.estimators import H2OAutoML
    from h2o3_tpu_torch.runtime import memory_ledger

    orig = H2OAutoML._candidate

    def candidate(self, name, cls, parms, x, y, training_frame):
        _, fn = orig(self, name, cls, parms, x, y, training_frame)

        def measured(job):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            est = fn(job)
            torch.cuda.synchronize()
            mem[name] = (torch.cuda.memory_allocated(dev) - before,
                         memory_ledger.measure(est.model)[1])
            return est
        return name, measured

    return mock.patch.object(H2OAutoML, "_candidate", candidate)


def automl_path(dev, card, rows: int = AML_ROWS, nfolds: int = AML_FOLDS,
                tag: str = "phase 33(a)"):
    """Phase 33(a): config 5's full plan through the public API, the
    random grids included; returns its record."""
    import shutil

    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2OAutoML
    from h2o3_tpu_torch.runtime import trainpool

    tf32_off()
    t_phase = time.perf_counter()
    fr = automl_frame(rows, AML_SEED)
    aml = H2OAutoML(max_runtime_secs=0, seed=AML_SEED, nfolds=nfolds,
                    device=str(dev))
    plan = automl_plan_names(aml)
    print(f"{tag} frame (HIGGS's shape): {rows} rows x {N_FEAT} features, "
          f"binary label; cut: {rows} rows of HIGGS's 11,000,000, "
          f"nfolds {nfolds}, the plan whole", flush=True)
    bad = []
    trainpool.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t_frame = time.perf_counter() - t_phase
    mem: dict = {}
    t0 = time.perf_counter()
    with automl_candidate_memory(dev, mem):
        aml.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    snap = trainpool.snapshot()
    names = automl_names(aml)
    board = [dict(name=n, model_id=r["model_id"], algo=r["algo"],
                  auc=r["auc"], logloss=r["logloss"])
             for n, r in zip(names, aml.leaderboard.rows)]
    for i, b in enumerate(board):
        print(f"{tag} leaderboard {i + 1:2d}: {b['name']:<30} "
              f"{b['algo']:<16} auc {b['auc']:.6f} logloss "
              f"{b['logloss']:.6f}", flush=True)
    cands = [dict(name=c["name"], status=c["status"], wall_s=c["wall_s"],
                  phases=c["phases"]) for c in snap["candidates"]]
    for c in cands:
        print(f"{tag} candidate {c['name']:<26} {c['status']:<6} "
              f"{c['wall_s']:8.3f} s {json.dumps(c['phases'])}", flush=True)
    families: dict = {}
    for c in cands:
        f = automl_family(c["name"])
        families[f] = round(families.get(f, 0.0) + c["wall_s"], 4)
    pool_wall, busy = snap["totals"]["wall_s"], snap["totals"]["busy_s"]
    rec = dict(rows=rows, nfolds=nfolds, wall_s=wall, models=len(board),
               family_wall_s=families, pools=snap["totals"]["pools"],
               pool_wall_s=pool_wall, pool_busy_s=busy,
               occupancy=busy / max(pool_wall, 1e-9),
               ensembles_and_rest_s=wall - pool_wall,
               peak_device_bytes=peak, fit_launches=fit_counts,
               leader=names[0], leader_auc=board[0]["auc"])
    errors = [e["message"] for e in aml.event_log.events
              if e["stage"] in ("error", "budget")]
    if errors:
        bad.append(f"failed or skipped steps: {errors}")
    missing = sorted(set(plan) - set(names))
    if missing or len(names) != len(plan):
        bad.append(f"steps missing from the leaderboard: {missing}, "
                   f"{len(names)} rows for a plan of {len(plan)}")
    if not {"xgboost", "glm", "drf", "gbm", "deeplearning",
            "stackedensemble"} <= {b["algo"] for b in board}:
        bad.append(f"families {sorted({b['algo'] for b in board})}")
    aucs = [b["auc"] for b in board]
    if not all(np.isfinite(aucs)) or aucs != sorted(aucs, reverse=True):
        bad.append(f"leaderboard not sorted by AUC: {aucs}")
    # every tree family builds its histograms through B1 (the "auto"
    # method on the card); nothing of AutoML's goes to B2
    if fit_counts["hist"] <= 0 or fit_counts["hist_rows"] != 0:
        bad.append(f"fit launches {fit_counts}")
    leader = aml.leader
    bases = (leader._parms.get("base_models") or []
             if leader.algo == "stackedensemble" else [leader])
    tree_leader = any(b.algo in AML_TREE_ALGOS for b in bases)
    zero_counts()
    t_p = time.perf_counter()
    rec["split_s"] = dict(frame=t_frame, train=wall,
                          leaderboard_checks=t_p - t0 - wall)
    pred = aml.predict(fr)
    torch.cuda.synchronize()
    rec["predict_s"] = time.perf_counter() - t_p
    rec["predict_launches"] = kernel_counts()
    if tree_leader and rec["predict_launches"]["score"] <= 0:
        bad.append("the leader's predict launched no forest kernel")
    tmp = tempfile.mkdtemp(prefix="h2o3_aml_")
    try:
        path = mojo.save_model(leader, tmp, force=True)
        got = mojo.load_model(path).predict(fr)
        rec["mojo_max_abs_err"] = float(np.abs(
            np.asarray(got.vec("1").data, np.float64)
            - np.asarray(pred.vec("1").data, np.float64)).max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["split_s"]["predict_mojo"] = time.perf_counter() - t_p
    if not rec["mojo_max_abs_err"] <= 1e-5:
        bad.append(f"predict {rec['mojo_max_abs_err']:.3e} from the MOJO")
    # each candidate leaves its model on the card and nothing of its folds;
    # the slack covers what a library keeps from its first call in the
    # process (a cuBLAS workspace is 32 MiB: a fresh process's first GLM
    # and first DeepLearning fit leave one each)
    rec["candidate_device_bytes"] = {n: dict(left=m[0], model=m[1])
                                     for n, m in mem.items()}
    kept = [n for n, (left, model) in mem.items()
            if left > 1.05 * model + (64 << 20)]
    if kept or len(mem) != len(cands):
        bad.append(f"candidates that left more than their model on the "
                   f"card (fold models kept?): {kept}")
    print(f"{tag} on {card}: " + json.dumps(rec), flush=True)
    PHASE33_WALLS["a"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    return rec


AML_CPU: dict = {}       # 33(b)'s CPU side: its child process and files
# the card phases' host work takes one core of the card's host: the child
# takes four of the rest, since its DRF_1 and XRT_1 fits scale with threads
AML_CPU_THREADS = 4


def automl_small_frame():
    return automl_frame(AML_SMALL_ROWS, AML_SEED + 1)


def automl_small_aml(device: str, fr):
    """33(b)'s AutoML on one device, and what 33(b) compares of it: the
    steps in building order, the leaderboard's order and metrics, the
    rows' CV holdout predictions."""
    from h2o3_tpu_torch.estimators import H2OAutoML

    aml = H2OAutoML(max_models=AML_SMALL_MODELS, nfolds=2, seed=AML_SEED,
                    device=device)
    aml.train(y="label", training_frame=fr)
    names = automl_names(aml)
    return aml, dict(
        built=[e["message"].split()[1] for e in aml.event_log.events
               if e["stage"] == "model"],
        names=names,
        rows={n: {k: float(r[k]) for k in ("auc", "logloss", "rmse", "mse")}
              for n, r in zip(names, aml.leaderboard.rows)},
        holdout={n: r["_est"].model._cv_holdout_pred.tolist()
                 for n, r in zip(names, aml.leaderboard.rows)
                 if getattr(r["_est"].model, "_cv_holdout_pred", None)
                 is not None})


def automl_small_grid(device: str, fr, parallelism: int) -> list:
    """33(b)'s RandomDiscrete grid of three GBMs on one device: each
    model's combo, training AUC and logloss, and predictions on fr."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2OGridSearch)

    grid = H2OGridSearch(
        H2OGradientBoostingEstimator(ntrees=20, seed=AML_SEED, device=device),
        AML_GRID, search_criteria=dict(strategy="RandomDiscrete",
                                       max_models=3, seed=AML_SEED),
        parallelism=parallelism)
    grid.train(y="label", training_frame=fr)
    # a failed combo shows as its error, so a comparison names it
    return [dict(combo=m._grid_combo, auc=float(m.auc()),
                 logloss=float(m.logloss()),
                 predict=np.asarray(m.predict(fr).vec("1").data,
                                    np.float64).tolist())
            for m in grid] + [dict(combo=f["params"], failed=f["error"])
                              for f in grid.failed]


def automl_cpu_child(out_path: str) -> None:
    """The child process's entry: 33(b)'s CPU run, its record to out_path."""
    torch.set_num_threads(AML_CPU_THREADS)
    t0 = time.perf_counter()
    fr = automl_small_frame()
    _, rec = automl_small_aml("cpu", fr)
    rec = dict(rec, grid=automl_small_grid("cpu", fr, 1),
               wall_s=time.perf_counter() - t0)
    with open(out_path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(out_path + ".tmp", out_path)


def automl_cpu_start() -> None:
    """Start 33(b)'s CPU run in a child process (kept off the card, on
    AML_CPU_THREADS threads) at phase 33's start, so its minutes overlap
    33(a) and 33(b)'s card runs and no earlier phase; the smoke reads its
    record at 33(b) and stops it on any exit."""
    if AML_CPU:
        return
    import atexit

    tmp = tempfile.mkdtemp(prefix="h2o3_aml_cpu_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = os.path.join(tmp, "record.json")
    log = open(os.path.join(tmp, "child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.automl_cpu_child({out!r})"],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    AML_CPU.update(proc=proc, dir=tmp, out=out, log=log,
                   t0=time.perf_counter())
    atexit.register(automl_cpu_stop)


def automl_cpu_stop() -> None:
    import shutil

    proc = AML_CPU.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if AML_CPU.get("log") is not None:
        AML_CPU["log"].close()
    if AML_CPU.get("dir"):
        shutil.rmtree(AML_CPU["dir"], ignore_errors=True)
    AML_CPU.clear()


def automl_cpu_record(timeout_s: float = 1200.0) -> dict:
    """Wait for the child's record (it started with phase 33)."""
    automl_cpu_start()
    proc = AML_CPU["proc"]
    try:
        rc = proc.wait(timeout=timeout_s)
        AML_CPU["log"].flush()
        if rc != 0 or not os.path.exists(AML_CPU["out"]):
            with open(os.path.join(AML_CPU["dir"], "child.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"phase 33(b): the CPU run exited {rc}:\n"
                                 + tail)
        with open(AML_CPU["out"]) as f:
            rec = json.load(f)
        rec["waited_s"] = time.perf_counter() - AML_CPU["t0"]
        return rec
    finally:
        automl_cpu_stop()


def automl_small_checks(dev, card):
    """Phase 33(b): a max_models=3, 2-fold AutoML and a RandomDiscrete grid
    of three GBMs on AML_SMALL_ROWS rows, on the card and on the CPU (its
    run started in a child process at phase 33's start), and the grid again
    on the card with two candidates in flight."""
    tf32_off()
    t_phase = time.perf_counter()
    fr = automl_small_frame()
    walls = {}
    t0 = time.perf_counter()
    _, crec = automl_small_aml(str(dev), fr)
    walls["card_automl"] = time.perf_counter() - t0
    grids = {}
    for par in (1, 2):
        t0 = time.perf_counter()
        grids[par] = automl_small_grid(str(dev), fr, par)
        walls[f"card_grid_par{par}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = automl_cpu_record()
    walls.update(cpu_s=cpu["wall_s"], cpu_waited_s=time.perf_counter() - t0)
    bad, out = [], dict(walls_s=walls)
    # card against CPU: the same steps in the same order, each row's
    # cross-validation metrics within its tolerance, the holdouts of the
    # rows that agree within theirs, the leaderboard in the CPU's order
    # where two rows lie farther apart than their tolerances
    if (crec["built"] != cpu["built"]
            or len(crec["built"]) != AML_SMALL_BUILT):
        bad.append(f"built {crec['built']} vs {cpu['built']}")
    if sorted(crec["names"]) != sorted(cpu["names"]):
        raise AssertionError(f"phase 33(b): leaderboards {crec['names']} "
                             f"vs {cpu['names']}")
    tol = {n: next(t for p, t in AML_TOLS if n.startswith(p))
           for n in crec["rows"]}
    diffs = {}
    for n, r in crec["rows"].items():
        diffs[n] = {k: abs(r[k] - cpu["rows"][n][k])
                    for k in ("auc", "logloss", "rmse")}
        d = max(diffs[n].values())
        if not d <= tol[n]:
            bad.append(f"{n}: card and CPU {d:.3e} apart")
        if n in crec["holdout"]:
            diffs[n]["holdout"] = float(np.abs(
                np.asarray(crec["holdout"][n])
                - np.asarray(cpu["holdout"][n])).max())
            htol = next((t for p, t in AML_HOLDOUT_TOLS if n.startswith(p)),
                        None)
            if htol is not None and not diffs[n]["holdout"] <= htol:
                bad.append(f"{n}: holdouts {diffs[n]['holdout']:.3e} apart")
    out["card_vs_cpu_diff"] = diffs
    rank = {n: i for i, n in enumerate(cpu["names"])}
    order = crec["names"]
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            gap = abs(crec["rows"][a]["auc"] - crec["rows"][b]["auc"])
            if gap > max(tol[a], tol[b]) and rank[a] > rank[b]:
                bad.append(f"{a} above {b} on the card only")
    out["order_card"], out["order_cpu"] = order, cpu["names"]
    g1 = grids[1]
    if [g["combo"] for g in g1] != [g["combo"] for g in cpu["grid"]]:
        bad.append("the grids' combos differ")
    gd = [max(abs(a["auc"] - b["auc"]), abs(a["logloss"] - b["logloss"]),
              float(np.abs(np.asarray(a["predict"])
                           - np.asarray(b["predict"])).max()))
          if "failed" not in a and "failed" not in b else float("inf")
          for a, b in zip(g1, cpu["grid"])]
    out["grid_combos"] = [g["combo"] for g in g1]
    out["grid_diff"] = gd
    if len(gd) != 3 or not max(gd) <= AML_GRID_TOL:
        bad.append(f"grid metrics or predictions {gd}")
    # two candidates in flight on the card: the same grid, bit for bit
    out["grid_par2_equal"] = grids[2] == g1
    if not out["grid_par2_equal"]:
        # what differs, model by model: combo, AUC, logloss, predictions
        out["grid_par2_diff"] = [
            dict(combo=(a["combo"], b["combo"]), auc=(a["auc"], b["auc"]),
                 logloss=(a["logloss"], b["logloss"]),
                 predict=float(np.abs(np.asarray(a["predict"])
                                      - np.asarray(b["predict"])).max()))
            if "failed" not in a and "failed" not in b else (a, b)
            for a, b in zip(g1, grids[2])] + [
            f"{len(g1)} entries at parallelism 1, {len(grids[2])} at 2"]
        bad.append("parallelism=2 gave another grid than 1")
    PHASE33_WALLS["b"] = time.perf_counter() - t_phase
    print(f"phase 33(b) on {card}, card vs cpu (tolerances by step "
          f"{dict(AML_TOLS)}, holdouts {dict(AML_HOLDOUT_TOLS)}, the grid "
          f"{AML_GRID_TOL}), the grid at parallelism 2 vs 1 bit for bit: "
          + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 33(b): " + "; ".join(bad))
    return out


# phase 34: the estimator engine's unsupervised estimators at full width.
# (a) K-Means on phase 14's Covertype-shaped predictors (UCI Covertype:
# 581,012 rows, 54 predictors; k = 7, its number of cover types), (b) PCA
# and SVD on phase 32's MNIST-shaped pixels (60,000 x 784, 717 not
# constant; k = nv = 50), (c) GLRM on a generated rank-10 frame of
# Covertype's shape with 10 % of its cells missing (k = 10, STANDARDIZE),
# (d) their MOJOs and the engine serving K-Means and PCA, (e) card vs CPU
# on the CPU tests' small frames; (f) none of them launches a
# hand-written kernel
UNSUP_KM = dict(k=COV_K, standardize=True, init="PlusPlus",
                max_iterations=50, seed=42)
UNSUP_PCA_K = 50
UNSUP_GLRM = dict(k=10, transform="STANDARDIZE", seed=42)
GLRM_ROWS, GLRM_COLS, GLRM_RANK, GLRM_MISSING = COV_ROWS, 54, 10, 0.1
# (a)'s bars: one f64 Lloyd step from the final (standardized) centres
# moves none by more than KM_FIXED_TOL, and its WSS is the model's
# tot_withinss within KM_WSS_TOL relative
KM_FIXED_TOL, KM_WSS_TOL = 1e-4, 1e-5
# (c)'s generator noise (sd a cell before each column's scale) and its
# bar: the holes' RMSE against the truth within GLRM_FLOOR_MULT times
# that noise in the standardized space, the least any fit can reach
GLRM_NOISE, GLRM_FLOOR_MULT = 0.3, 1.5
UNSUP_CHECK_ROWS = 2_000
# (b)'s bars: eigenvalues within PCA_EIG_TOL relative of an f64 eigh of
# an f64 Gram of the same matrix, each eigenpair's residual there within
# PCA_EIG_TOL·λ, and each eigenvector within PCA_EIG_TOL entrywise where
# Davis-Kahan (2‖E‖₂ / gap, E the f32 Gram's error) bounds it below that;
# Randomized's first PCA_RAND_SD standard deviations within PCA_RAND_TOL
# relative of GramSVD's; SVD's uᵀu within SVD_ORTHO_TOL of I
PCA_EIG_TOL, PCA_RAND_SD, PCA_RAND_TOL, SVD_ORTHO_TOL = 1e-4, 10, 0.02, 1e-3
# (e)'s bars, the CPU tests' (tests/test_torch_kmeans.py, _pca_svd.py,
# _glrm.py)
UNSUP_SMALL_TOLS = dict(center=1e-5, ss=1e-5, eig_abs=1e-4, eig_rel=1e-5,
                        score=1e-4, svd=1e-4, glrm_obj=1e-4, glrm_fit=1e-3)
PHASE34_WALLS: dict = {}


def make_lowrank_like(n: int, p: int = GLRM_COLS, rank: int = GLRM_RANK,
                      seed: int = 0):
    """(frame, full f32 matrix, each column's noise sd): n x p, rank
    `rank` plus noise (signal variance about `rank` a cell, noise
    GLRM_NOISE²), each column at its own offset and scale, then
    GLRM_MISSING of the cells NaN at random (the full matrix keeps them).
    The factors' law comes from a fixed seed."""
    from h2o3_tpu_torch.frame.frame import Frame

    law = np.random.default_rng(3_000)
    V = law.normal(size=(rank, p)).astype(np.float32)
    scale = law.gamma(2.0, 50.0, p).astype(np.float32)
    offset = law.normal(0.0, 500.0, p).astype(np.float32)
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(n, rank)).astype(np.float32) @ V
    full += np.float32(GLRM_NOISE) * rng.standard_normal((n, p), np.float32)
    full = full * scale + offset
    holes = rng.random((n, p), np.float32) < GLRM_MISSING
    A = np.where(holes, np.float32(np.nan), full)
    return (Frame.from_numpy(A, names=[f"g{j}" for j in range(p)]), full,
            GLRM_NOISE * scale.astype(np.float64))


def _frame_matrix(fr) -> np.ndarray:
    return np.column_stack([fr.vec(n).numeric_np() for n in fr.names])


def _kmeans_mismatch_ties(X64, cents, got, want) -> int:
    """Rows whose two assignments differ though their two nearest centres
    are NOT within 1e-5 relative in f64 (a near-tie may go either way)."""
    bad = 0
    for i in np.nonzero(got != want)[0]:
        d2 = ((X64[i][None, :] - cents) ** 2).sum(1)
        a, b = d2[int(got[i])], d2[int(want[i])]
        bad += abs(a - b) > 1e-5 * max(a, b)
    return bad


def unsup_kmeans_path(dev, card):
    """Phase 34(a): K-Means on the Covertype-shaped predictors; returns
    (record, model, frame)."""
    from h2o3_tpu_torch.estimators import H2OKMeansEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import estimator_engine as est
    from h2o3_tpu_torch.models import kmeans as km

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    X, _ = make_covtype_like(COV_ROWS, 5)
    fr = Frame.from_numpy(X, names=COV_NAMES)
    del X
    gen_s = time.perf_counter() - t0
    seen = {}
    real_seed = km._seed_centers

    def spy(Xh, k, init, rng):
        seen["X"], seen["cents"] = Xh, real_seed(Xh, k, init, rng)
        return seen["cents"]

    bad = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with mock.patch.object(km, "_seed_centers", spy):
        model = H2OKMeansEstimator(device=str(dev), **UNSUP_KM).train(
            training_frame=fr).model
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    plan = est.est_stats()["plans"][-1]
    ft = model.fit_timings
    X64 = seen["X"].astype(np.float64)
    c0 = seen["cents"].astype(np.float64)
    xsq = (X64 * X64).sum(1)
    seeded = float(np.maximum(xsq[:, None] - 2.0 * X64 @ c0.T
                              + (c0 * c0).sum(1)[None, :], 0).min(1).sum())
    wss, bss, tss = (model.tot_withinss(), model.betweenss(), model.totss())
    # one Lloyd step in f64 from the final centres: assignments, the WSS
    # there, and the centres it moves to
    t2 = time.perf_counter()
    c = np.asarray(model.centers_std, np.float64)
    d2 = np.maximum(xsq[:, None] - 2.0 * X64 @ c.T
                    + (c * c).sum(1)[None, :], 0)
    wss64 = float(d2.min(1).sum())
    oh = (d2.argmin(1)[:, None] == np.arange(len(c))[None, :]).astype(
        np.float64)
    cnt = oh.sum(0)
    c_next = np.where(cnt[:, None] > 0,
                      (oh.T @ X64) / np.maximum(cnt, 1)[:, None], c)
    move = float(np.abs(c_next - c).max())
    wss_rel = abs(float(wss) - wss64) / wss64
    check_s = time.perf_counter() - t2
    rec = dict(card=card, rows=fr.nrow, cols=len(model.x),
               params=UNSUP_KM, wall_s=wall, fit_timings=ft,
               iterations=model.iterations, converged=plan.get("converged"),
               lloyd_ms_per_iteration=ft["steps_s"] / model.iterations * 1e3,
               seeded_wss=seeded, tot_withinss=float(wss),
               betweenss=float(bss), totss=float(tss), f64_wss=wss64,
               f64_wss_rel=wss_rel, f64_step_centre_move=move,
               generator_s=gen_s, check_s=check_s)
    print(f"phase 34(a) on {card}: K-Means {fr.nrow} x {len(model.x)}, "
          f"k={UNSUP_KM['k']}, fit {wall:.3f} s = host matrix "
          f"{ft['pack_s']:.3f} + seeding {ft['init_s']:.3f} + H2D "
          f"{ft['h2d_s']:.3f} + Lloyd {ft['steps_s']:.3f} "
          f"({model.iterations} iterations, "
          f"{rec['lloyd_ms_per_iteration']:.3f} ms each, converged "
          f"{plan.get('converged')}) + metrics {ft['metrics_s']:.3f}; WSS "
          f"{wss:.6g} from the seeds' {seeded:.6g}, totss {tss:.6g}; an "
          f"f64 Lloyd step from the final centres moves them {move:.3e}, "
          f"its WSS {wss64:.9g} ({wss_rel:.3e} relative)", flush=True)
    if not float(wss) <= seeded * (1 + 1e-6):
        bad.append(f"WSS {wss} above the seeded centres' {seeded}")
    if not move <= KM_FIXED_TOL:
        bad.append(f"not a fixed point: an f64 Lloyd step moves the centres "
                   f"{move:.3e}")
    if not wss_rel <= KM_WSS_TOL:
        bad.append(f"tot_withinss {wss} is {wss_rel:.3e} from the f64 WSS "
                   f"{wss64}")
    if not np.all(np.isfinite(model.centers())) or plan["path"] != "fused":
        bad.append(f"centres not finite or path {plan['path']}")
    PHASE34_WALLS["a"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 34(a): " + "; ".join(bad))
    return rec, model, fr


def _gram_reference(X32: np.ndarray, k: int):
    """(evals, evecs, every eigenvalue, Gram) of the f64 Gram of the f32
    matrix divided by n − 1: the first k eigenpairs ordered and signed as
    the estimators report them, and the whole spectrum, descending."""
    X64 = X32.astype(np.float64)
    G = X64.T @ X64 / max(X32.shape[0] - 1, 1)
    evals, evecs = np.linalg.eigh(G)
    order = np.argsort(evals)[::-1]
    evals, top = np.maximum(evals[order], 0), evecs[:, order[:k]]
    # the largest |loading| of each vector positive
    lead = top[np.abs(top).argmax(0), np.arange(k)]
    return evals[:k], top * np.where(lead < 0, -1.0, 1.0), evals, G


def unsup_pca_svd_path(dev, card):
    """Phase 34(b): PCA (GramSVD and Randomized, STANDARDIZE) and SVD
    (GramSVD, keep_u) on the MNIST-shaped pixels at k = nv = 50; returns
    (record, GramSVD PCA model, SVD model, frame)."""
    from h2o3_tpu_torch.estimators import (
        H2OPrincipalComponentAnalysisEstimator,
        H2OSingularValueDecompositionEstimator)
    from h2o3_tpu_torch.models import estimator_engine as est

    tf32_off()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr = make_mnist_like(DL_ROWS, 0)
    gen_s = time.perf_counter() - t0
    pixels = [f"C{j + 1}" for j in range(DL_SIDE * DL_SIDE)]
    bad, fits = [], {}
    for name, cls, params in (
            ("pca_gram", H2OPrincipalComponentAnalysisEstimator,
             dict(k=UNSUP_PCA_K, transform="STANDARDIZE",
                  pca_method="GramSVD")),
            ("pca_randomized", H2OPrincipalComponentAnalysisEstimator,
             dict(k=UNSUP_PCA_K, transform="STANDARDIZE",
                  pca_method="Randomized", seed=42)),
            ("svd_gram", H2OSingularValueDecompositionEstimator,
             dict(nv=UNSUP_PCA_K, svd_method="GramSVD", keep_u=True))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = cls(device=str(dev), **params).train(x=pixels,
                                                  training_frame=fr).model
        torch.cuda.synchronize()
        fits[name] = (m, time.perf_counter() - t1)
    pca, svd = fits["pca_gram"][0], fits["svd_gram"][0]
    rand = fits["pca_randomized"][0]
    # the same matrix on the host in f64, and the card's own f32 Gram of
    # it for the Davis-Kahan bound
    t2 = time.perf_counter()
    _, X = est.host_matrix(fr, pca.x, standardize=True)
    ev64, V64, every, G64 = _gram_reference(X, UNSUP_PCA_K)
    Xd = torch.from_numpy(X).to(dev)
    G32 = (Xd.T @ Xd).cpu().numpy().astype(np.float64) / (X.shape[0] - 1)
    del Xd
    e_norm = float(np.linalg.norm(G32 - G64, 2))
    ev, V = np.asarray(pca.eigenvalues), np.asarray(pca.eigenvectors)
    rel = np.abs(ev - ev64) / ev64
    resid = np.linalg.norm(G64 @ V - V * ev[None, :], axis=0) / ev
    # each eigenvalue's distance to its neighbours in the whole spectrum
    spread = np.r_[np.inf, every]
    gap = np.minimum(spread[:-2] - spread[1:-1],
                     spread[1:-1] - spread[2:])[:UNSUP_PCA_K]
    bound = 2 * e_norm / gap
    vec_err = np.abs(V - V64).max(0)
    pinned = bound <= PCA_EIG_TOL
    sd_g = pca.importance["Standard deviation"][:PCA_RAND_SD]
    sd_r = rand.importance["Standard deviation"][:PCA_RAND_SD]
    sd_rel = np.abs(sd_r - sd_g) / sd_g
    u = svd.u
    ortho = float(np.abs(u.T @ u - np.eye(u.shape[1])).max())
    check_s = time.perf_counter() - t2
    rec = dict(card=card, rows=fr.nrow, cols=len(pca.x), k=UNSUP_PCA_K,
               walls={n: w for n, (_, w) in fits.items()},
               fit_timings={n: m.fit_timings for n, (m, _) in fits.items()},
               eig_rel_max=float(rel.max()), resid_rel_max=float(resid.max()),
               gram_err_norm=e_norm, pinned_vectors=int(pinned.sum()),
               pinned_vec_err_max=float(vec_err[pinned].max()
                                        if pinned.any() else 0.0),
               vec_err_max=float(vec_err.max()),
               randomized_sd_rel_max=float(sd_rel.max()),
               svd_utu_max_dev=ortho, top_sd=[float(s) for s in sd_g[:5]],
               generator_s=gen_s, check_s=check_s)
    print(f"phase 34(b) on {card}: {fr.nrow} x {len(pca.x)} pixels, k = "
          f"{UNSUP_PCA_K}: PCA GramSVD {fits['pca_gram'][1]:.3f} s, "
          f"Randomized {fits['pca_randomized'][1]:.3f} s, SVD GramSVD + u "
          f"{fits['svd_gram'][1]:.3f} s; eigenvalues within "
          f"{rec['eig_rel_max']:.3e} relative of the f64 eigh, residuals "
          f"{rec['resid_rel_max']:.3e}·λ, ‖E‖₂ {e_norm:.3e}, "
          f"{rec['pinned_vectors']} vectors pinned by Davis-Kahan within "
          f"{rec['pinned_vec_err_max']:.3e} (all {rec['vec_err_max']:.3e}); "
          f"Randomized sd within {rec['randomized_sd_rel_max']:.3e}; "
          f"uᵀu within {ortho:.3e} of I", flush=True)
    print("phase 34(b) fits: " + json.dumps(rec), flush=True)
    if not (rel.max() <= PCA_EIG_TOL and resid.max() <= PCA_EIG_TOL):
        bad.append(f"eigenvalues {rel.max():.3e} / residuals "
                   f"{resid.max():.3e} past {PCA_EIG_TOL}")
    if pinned.any() and vec_err[pinned].max() > PCA_EIG_TOL:
        bad.append(f"pinned eigenvectors {vec_err[pinned].max():.3e} off")
    if sd_rel.max() > PCA_RAND_TOL:
        bad.append(f"Randomized sd {sd_rel.max():.3e} from GramSVD's")
    if ortho > SVD_ORTHO_TOL:
        bad.append(f"SVD uᵀu {ortho:.3e} from I")
    for name, vals in (("pca_gram", ev), ("pca_randomized",
                                          np.asarray(rand.eigenvalues)),
                       ("svd_gram", np.asarray(svd.d))):
        if not (np.all(np.isfinite(vals)) and np.all(np.diff(vals) <= 0)):
            bad.append(f"{name}: values not finite and non-increasing")
    PHASE34_WALLS["b"] = time.perf_counter() - t_phase
    tf32_off()
    if bad:
        raise AssertionError("phase 34(b): " + "; ".join(bad))
    return rec, pca, svd, fr


def unsup_glrm_path(dev, card):
    """Phase 34(c): GLRM on the rank-10 Covertype-shaped frame with holes;
    returns (record, model, frame)."""
    from h2o3_tpu_torch.estimators import H2OGeneralizedLowRankEstimator

    tf32_off()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr, full, noise = make_lowrank_like(GLRM_ROWS, seed=7)
    gen_s = time.perf_counter() - t0
    bad = []
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = H2OGeneralizedLowRankEstimator(device=str(dev),
                                           **UNSUP_GLRM).train(
        training_frame=fr).model
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    ft = model.fit_timings
    hist = [o for _, o in model.objective_history]
    rises = [(a, b) for a, b in zip(hist, hist[1:]) if b > a * (1 + 1e-6)]
    # the holes: reconstruct against the truth and against column means
    # (0 in the standardized space), both in the standardized space
    t2 = time.perf_counter()
    rec_std = _frame_matrix(model.reconstruct(fr))
    recon_s = time.perf_counter() - t2
    A = _frame_matrix(fr)
    holes = np.isnan(A)
    di = model.dinfo
    truth = (full.astype(np.float64) - di.means) / di.stds
    rmse = float(np.sqrt(np.mean((rec_std[holes] - truth[holes]) ** 2)))
    rmse_mean = float(np.sqrt(np.mean(truth[holes] ** 2)))
    # the noise floor: the generator's noise in the standardized space,
    # over the same holes
    floor = float(np.sqrt(np.sum(holes.sum(0) * (noise / di.stds) ** 2)
                          / holes.sum()))
    # the fit's RMSE on the observed cells, from its objective (γ ≈ 1e-6),
    # and the floor there: the true factors reach that floor, so the
    # optimum of the objective lies at or below it
    seen_cells = ~holes
    fit_rmse = float(np.sqrt(model.objective / seen_cells.sum()))
    floor_seen = float(np.sqrt(np.sum(seen_cells.sum(0)
                                      * (noise / di.stds) ** 2)
                               / seen_cells.sum()))
    # transform on the card against the reference's row loop (f64 Y)
    sub = A[:UNSUP_CHECK_ROWS]
    As = (sub - di.means) / di.stds
    Y = np.asarray(model.Y, np.float64)
    loop = np.zeros((len(As), Y.shape[0]))
    for i in range(len(As)):
        m = ~np.isnan(As[i])
        G = Y[:, m] @ Y[:, m].T + 1e-6 * np.eye(Y.shape[0])
        loop[i] = np.linalg.solve(G, Y[:, m] @ As[i, m])
    card_t = _frame_matrix(model.transform(fr.take(np.arange(
        UNSUP_CHECK_ROWS))))
    t_err = float(np.abs(card_t - loop).max())
    rec = dict(card=card, rows=fr.nrow, cols=len(model.x), params=UNSUP_GLRM,
               missing_share=float(holes.mean()), wall_s=wall,
               fit_timings=ft, iterations=model.iterations,
               als_ms_per_iteration=ft["steps_s"] / model.iterations * 1e3,
               objective=model.objective, objective_checks=hist,
               peak_bytes=peak, reconstruct_s=recon_s, holes_rmse=rmse,
               holes_rmse_column_mean=rmse_mean, holes_noise_floor=floor,
               observed_rmse=fit_rmse, observed_noise_floor=floor_seen,
               transform_max_err=t_err,
               generator_s=gen_s)
    print(f"phase 34(c) on {card}: GLRM {fr.nrow} x {len(model.x)}, k = "
          f"{UNSUP_GLRM['k']}, {holes.mean() * 100:.2f} % missing: fit "
          f"{wall:.3f} s = expand {ft['pack_s']:.3f} + SVD init "
          f"{ft['init_s']:.3f} + H2D {ft['h2d_s']:.3f} + ALS "
          f"{ft['steps_s']:.3f} ({model.iterations} iterations, "
          f"{rec['als_ms_per_iteration']:.3f} ms each); objective "
          f"{model.objective:.6g} (RMSE {fit_rmse:.4f} on the observed "
          f"cells, their noise floor {floor_seen:.4f}), peak "
          f"{peak / 2**30:.2f} GiB; holes RMSE "
          f"{rmse:.4f} against the noise floor {floor:.4f} (column means' "
          f"{rmse_mean:.4f}); transform "
          f"within {t_err:.3e} of the row loop", flush=True)
    if rises or not np.all(np.isfinite(hist)):
        bad.append(f"objective rose between checks: {rises}")
    if not fit_rmse <= floor_seen:
        bad.append(f"observed cells' RMSE {fit_rmse} above the true "
                   f"factors' {floor_seen}")
    if not rmse <= GLRM_FLOOR_MULT * floor:
        bad.append(f"holes RMSE {rmse} past {GLRM_FLOOR_MULT} x the noise "
                   f"floor {floor}")
    if not t_err <= 1e-4:
        bad.append(f"transform {t_err:.3e} from the row loop")
    PHASE34_WALLS["c"] = time.perf_counter() - t_phase
    tf32_off()
    if bad:
        raise AssertionError("phase 34(c): " + "; ".join(bad))
    return rec, model, fr


def unsup_mojo_serving(dev, card, models):
    """Phase 34(d): each model saved and loaded, the numpy scorer against
    `predict` on UNSUP_CHECK_ROWS rows (GLRM's `transform` too); the engine
    serving K-Means and PCA equal to `predict` with no fallback."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    t_phase = time.perf_counter()
    bad, out = [], {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_unsup_") as d:
        for name, (model, fr) in models.items():
            sub = fr.take(np.arange(UNSUP_CHECK_ROWS))
            t0 = time.perf_counter()
            scorer = mojo.load_model(mojo.save_model(model, d,
                                                     f"{name}.h2o3"))
            got = _frame_matrix(scorer.predict(sub))
            want = _frame_matrix(model.predict(sub))
            if name == "kmeans":
                X64 = model.dinfo.transform(sub).astype(np.float64)
                err = float(_kmeans_mismatch_ties(
                    X64, model.centers_std.astype(np.float64),
                    got[:, 0], want[:, 0]))
                out[name] = dict(mismatched=int((got != want).sum()),
                                 not_ties=err)
            else:
                err = float(np.abs(got - want).max())
                out[name] = dict(max_abs_err=err)
                if name == "glrm":
                    terr = float(np.abs(
                        _frame_matrix(scorer.transform(sub))
                        - _frame_matrix(model.transform(sub))).max())
                    out[name]["transform_max_abs_err"] = terr
                    err = max(err, terr)
            out[name]["s"] = time.perf_counter() - t0
            if err > 1e-5:
                bad.append(f"{name}: MOJO {err:.3e} from predict")
    engine = ScoringEngine(ServingConfig())
    try:
        for name in ("kmeans", "pca_gram"):
            model, fr = models[name]
            batch = fr.take(np.arange(100, 357))
            served = _frame_matrix(engine.score(f"unsup_{name}", model,
                                                batch))
            diff = float(np.abs(served - _frame_matrix(
                model.predict(batch))).max())
            out[name]["served_max_abs_err"] = diff
            if diff > 1e-12:
                bad.append(f"{name}: served {diff:.3e} from predict")
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    out["fallback_scores"] = snap["totals"]["fallback_scores"]
    if snap["totals"]["fallback_scores"] or snap["totals"]["errors"]:
        bad.append(f"serving {snap['totals']}")
    PHASE34_WALLS["d"] = time.perf_counter() - t_phase
    print(f"phase 34(d) on {card}: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 34(d): " + "; ".join(bad))
    return out


def unsup_small_checks(dev, card):
    """Phase 34(e): card against CPU on the CPU tests' small frames, with
    their tolerances (UNSUP_SMALL_TOLS)."""
    from h2o3_tpu_torch.estimators import (
        H2OGeneralizedLowRankEstimator, H2OKMeansEstimator,
        H2OPrincipalComponentAnalysisEstimator,
        H2OSingularValueDecompositionEstimator)
    from h2o3_tpu_torch.frame.frame import Frame

    tf32_off()
    t_phase = time.perf_counter()
    tol = UNSUP_SMALL_TOLS
    bad, out = [], {}

    def pair(cls, fr, **params):
        return [cls(device=d, **params).train(training_frame=fr).model
                for d in (str(dev), "cpu")]

    rng = np.random.default_rng(2)
    centers = rng.uniform(-10, 10, (3, 4))
    blobs = Frame.from_numpy(np.concatenate(
        [c + rng.normal(size=(300, 4)) for c in centers]))
    for init in ("PlusPlus", "Furthest", "Random"):
        a, c = pair(H2OKMeansEstimator, blobs, k=3, max_iterations=20,
                    seed=1, init=init)
        cerr = float(np.abs(a.centers() - c.centers()).max())
        same = np.array_equal(_frame_matrix(a.predict(blobs)),
                              _frame_matrix(c.predict(blobs)))
        wrel = abs(a.tot_withinss() - c.tot_withinss()) / c.tot_withinss()
        out[f"kmeans_{init}"] = dict(center_err=cerr, same_assign=same,
                                     iterations=(a.iterations, c.iterations),
                                     wss_rel=float(wrel))
        if not (cerr <= tol["center"] * max(1, np.abs(c.centers()).max())
                and same and a.iterations == c.iterations
                and wrel <= tol["ss"]):
            bad.append(f"kmeans {init}: {out[f'kmeans_{init}']}")
    rng = np.random.default_rng(1)
    Z = rng.normal(size=(600, 6)) * np.asarray([6, 4, 2.5, 1.5, 0.8, 0.3])
    Q, _ = np.linalg.qr(np.random.default_rng(99).normal(size=(6, 6)))
    spec = Frame.from_numpy(Z @ Q.T + np.arange(1.0, 7.0))
    for method in ("GramSVD", "Randomized"):
        a, c = pair(H2OPrincipalComponentAnalysisEstimator, spec, k=3,
                    pca_method=method, transform="STANDARDIZE", seed=6)
        verr = float(np.abs(a.eigenvectors - c.eigenvectors).max())
        erel = float((np.abs(a.eigenvalues - c.eigenvalues)
                      / c.eigenvalues).max())
        serr = float(np.abs(_frame_matrix(a.predict(spec))
                            - _frame_matrix(c.predict(spec))).max())
        out[f"pca_{method}"] = dict(vec_err=verr, eig_rel=erel,
                                    score_err=serr)
        if not (verr <= tol["eig_abs"] and erel <= tol["eig_rel"]
                and serr <= tol["score"]):
            bad.append(f"pca {method}: {out[f'pca_{method}']}")
    for method in ("GramSVD", "Power", "Randomized"):
        a, c = pair(H2OSingularValueDecompositionEstimator, spec, nv=3,
                    svd_method=method, seed=4)
        errs = dict(d_rel=float((np.abs(a.d - c.d) / c.d).max()),
                    v=float(np.abs(a.v - c.v).max()),
                    u=float(np.abs(a.u - c.u).max()))
        out[f"svd_{method}"] = errs
        if max(errs.values()) > tol["svd"]:
            bad.append(f"svd {method}: {errs}")
    rng = np.random.default_rng(1)
    L = (rng.normal(size=(400, 3)) @ rng.normal(size=(3, 8))
         + 0.05 * rng.normal(size=(400, 8)))
    L = L * np.linspace(1, 3, 8) + np.arange(8)
    L[rng.random(L.shape) < 0.1] = np.nan
    low = Frame.from_numpy(L)
    for init in ("SVD", "Random"):
        a, c = pair(H2OGeneralizedLowRankEstimator, low, k=3, seed=2,
                    init=init, max_iterations=200, transform="STANDARDIZE")
        orel = abs(a.objective - c.objective) / abs(c.objective)
        ferr = max(float(np.abs(_frame_matrix(getattr(a, f)(low))
                                - _frame_matrix(getattr(c, f)(low))).max())
                   for f in ("reconstruct", "transform"))
        out[f"glrm_{init}"] = dict(obj_rel=orel, fit_err=ferr)
        if orel > tol["glrm_obj"] or ferr > tol["glrm_fit"]:
            bad.append(f"glrm {init}: {out[f'glrm_{init}']}")
    PHASE34_WALLS["e"] = time.perf_counter() - t_phase
    print(f"phase 34(e) on {card}, card vs cpu (tolerances "
          f"{json.dumps(tol)}): " + json.dumps(out), flush=True)
    tf32_off()
    if bad:
        raise AssertionError("phase 34(e): " + "; ".join(bad))
    return out


def unsupervised_path(dev, card):
    """Phase 34: (a)-(e) in turn with every launch count set to 0 before
    and read after; (f) none of them launched a hand-written kernel."""
    zero_counts()
    km_rec, km_model, km_fr = unsup_kmeans_path(dev, card)
    pca_rec, pca, svd, px_fr = unsup_pca_svd_path(dev, card)
    glrm_rec, glrm_model, glrm_fr = unsup_glrm_path(dev, card)
    mojo_rec = unsup_mojo_serving(dev, card, dict(
        kmeans=(km_model, km_fr), pca_gram=(pca, px_fr),
        svd_gram=(svd, px_fr), glrm=(glrm_model, glrm_fr)))
    del km_fr, px_fr, glrm_fr
    unsup_small_checks(dev, card)
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"phase 34(f): hand-written kernel launches {json.dumps(counts)}",
          flush=True)
    if any(counts.values()):
        raise AssertionError(f"phase 34(f): a hand-written kernel ran: "
                             f"{counts}")
    return dict(kmeans=km_rec, pca_svd=pca_rec, glrm=glrm_rec,
                mojo=mojo_rec)


# phase 35: the isolation forests and the uplift DRF at full width. (a)
# IsolationForest and (b) ExtendedIsolationForest at their defaults on a
# generated frame of the ULB credit-card-fraud dataset's shape (Dal Pozzolo
# et al., "Calibrating Probability with Undersampling for Unbalanced
# Classification", 2015: 284,807 transactions x 30 columns, Time, V1-V28
# and Amount, 492 frauds), the frauds planted as scattered anomalies; (c)
# UpliftDRF at its defaults on a generated frame of the Criteo Uplift v2.1
# shape (Diemert et al., "A Large Scale Benchmark for Uplift Modeling",
# 2018: 13,979,592 rows, 12 continuous features f0-f11, treatment 85 %,
# visit 4.7 %), cut to UP_ROWS rows, with a known uplift on a region of
# its features; (d) their MOJOs and the engine serving each; (e) card vs
# CPU on the CPU tests' small frames; (f) only (c)-(e)'s uplift work
# launches a hand-written kernel: B1 and the forest scorer
CC_ROWS, CC_FRAUD = 284_807, 492
CC_NAMES = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
CC_TIME_S = 172_792            # the dataset's two days, in seconds
# the V columns in which the generated frauds stand out
CC_FRAUD_COLS = ("V3", "V4", "V10", "V11", "V12", "V14", "V16", "V17")
# (a)/(b)'s bars (tests/test_unsupervised.py): the frauds' mean score
# above the rest's by IF_GAP, and more than IF_TOP of them in the top 5 %
IF_GAP, IF_TOP = 0.1, 0.8
CRITEO_ROWS, UP_ROWS = 13_979_592, 1_000_000
UP_NAMES = [f"f{i}" for i in range(12)]
UP_DEPTH, UP_TREES, UP_NBINS = 10, 50, 32    # the defaults; B for nbins 20
UP_CHECK_ROWS = 2_000
UP_ROOT_TOL = 1e-6
# (e)'s tolerances, the CPU tests' (tests/test_torch_isolation_forest.py,
# tests/test_torch_uplift.py)
IF_SMALL_TOLS = dict(if_path=1e-12, eif=1e-6, uplift_pred=1e-5)
PHASE35_WALLS: dict = {}


def make_creditcard_like(seed: int):
    """(frame, fraud mask) of the ULB dataset's shape: Time uniform over
    its two days, sorted; V1-V28 normal with falling standard deviations
    (1.96 to 0.33, a PCA's components, as the dataset's); Amount lognormal
    (median about 22, mean about 86, in cents); CC_FRAUD rows at random,
    each offset in the CC_FRAUD_COLS by 4-8 of their standard deviations
    with random signs."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    n = CC_ROWS
    sd = np.linspace(1.96, 0.33, 28)
    X = np.empty((n, 30))
    X[:, 0] = np.sort(rng.uniform(0, CC_TIME_S, n))
    X[:, 1:29] = rng.standard_normal((n, 28)) * sd
    X[:, 29] = np.round(rng.lognormal(3.1, 1.65, n), 2)
    fraud = np.zeros(n, bool)
    fraud[rng.choice(n, CC_FRAUD, replace=False)] = True
    cols = np.asarray([CC_NAMES.index(c) for c in CC_FRAUD_COLS])
    k = int(fraud.sum())
    X[np.ix_(fraud, cols)] += (rng.choice([-1.0, 1.0], (k, len(cols)))
                               * rng.uniform(4, 8, (k, len(cols)))
                               * sd[cols - 1])
    return Frame.from_numpy(X, names=CC_NAMES), fraud


def make_criteo_uplift_like(n: int, seed: int):
    """(frame, τ region mask) of the Criteo Uplift v2.1 shape: 12
    continuous features (f2, f6 and f9 on a half-unit grid, f5 and f8
    log-normal, the rest normal), `treatment` at 85 % and `visit`
    Bernoulli(0.039 + 0.012·tanh(f1) + treatment·τ(x)), τ = 0.045 on the
    region f0 > 0.8 and f3 < 0 (about 10.6 % of rows) and 0.005
    elsewhere: visits about 4.7 %, treatment and visit factors."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 12))
    X[:, [2, 6, 9]] = np.round(X[:, [2, 6, 9]] * 2) / 2
    X[:, [5, 8]] = np.exp(X[:, [5, 8]])
    treat = (rng.random(n) < 0.85).astype(np.float64)
    region = (X[:, 0] > 0.8) & (X[:, 3] < 0)
    p = (0.039 + 0.012 * np.tanh(X[:, 1])
         + treat * np.where(region, 0.045, 0.005))
    visit = (rng.random(n) < p).astype(np.float64)
    fr = Frame.from_numpy(np.column_stack([X, treat, visit]),
                          names=UP_NAMES + ["treatment", "visit"])
    return fr.asfactor("treatment").asfactor("visit"), region


def anomaly_bars(s: np.ndarray, fraud: np.ndarray) -> dict:
    """The frauds' mean score over the rest's, and the share of frauds
    above the 95th percentile of all scores."""
    q = np.quantile(s, 0.95)
    return dict(gap=float(s[fraud].mean() - s[~fraud].mean()),
                top5=float((s[fraud] > q).mean()))


def if_paths(dev, card):
    """Phase 35(a, b): IsolationForest and ExtendedIsolationForest (at
    extension 0 and 29 on all 30 columns, and 27 on V1-V28 alone) on the
    credit-card-shaped frame; returns ({name: (model, frame)}, record)."""
    from h2o3_tpu_torch.estimators import (
        H2OExtendedIsolationForestEstimator, H2OIsolationForestEstimator)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr, fraud = make_creditcard_like(35)
    gen_s = time.perf_counter() - t0
    bad, out, models = [], dict(card=card, rows=fr.nrow, generator_s=gen_s), {}
    vcols = CC_NAMES[1:29]
    cases = (("isoforest", H2OIsolationForestEstimator, {}, CC_NAMES, True),
             ("eif_ext0", H2OExtendedIsolationForestEstimator,
              dict(extension_level=0), CC_NAMES, True),
             ("eif_ext29", H2OExtendedIsolationForestEstimator,
              dict(extension_level=29), CC_NAMES, False),
             ("eif_v_ext27", H2OExtendedIsolationForestEstimator,
              dict(extension_level=27), vcols, True))
    for name, cls, params, x, held in cases:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model = cls(seed=42, device=str(dev), **params).train(
            x=x, training_frame=fr).model
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        pred = model.predict(fr)
        pred_s = time.perf_counter() - t2
        col = "predict" if name == "isoforest" else "anomaly_score"
        s = pred.vec(col).numeric_np()
        ml = pred.vec("mean_length").numeric_np()
        rec = dict(fit_s=fit_s, fit_timings=model.fit_timings,
                   predict_s=pred_s, cols=len(x), **anomaly_bars(s, fraud))
        out[name] = rec
        models[name] = (model, fr)
        if not (np.isfinite(s).all() and (s > 0).all() and (s <= 1).all()
                and (ml >= 0).all()):
            bad.append(f"{name}: scores outside (0, 1] or negative lengths")
        if held and not (rec["gap"] > IF_GAP and rec["top5"] > IF_TOP):
            bad.append(f"{name}: frauds gap {rec['gap']:.4f} (bar {IF_GAP}) "
                       f"top 5 % {rec['top5']:.4f} (bar {IF_TOP})")
        print(f"phase 35({'a' if name == 'isoforest' else 'b'}) on {card}: "
              f"{name} {fr.nrow} x {len(x)}, fit {fit_s:.3f} s "
              f"{json.dumps(model.fit_timings)}, predict {fr.nrow} rows "
              f"{pred_s:.3f} s; frauds' score gap {rec['gap']:.5f}, "
              f"{rec['top5']:.4f} of them in the top 5 %"
              + ("" if held else " (not held to the bars: Time's scale, "
                 "sd ~50,000 s, fills every oblique projection)"),
              flush=True)
    PHASE35_WALLS["ab"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 35(a, b): " + "; ".join(bad))
    return models, out


def _hist_passes(model, codes_w, y_d, treat_d, rate: float, seed: int):
    """The node ids (int32) and {w, y·w, 0} values of tree 0's 22 B1
    passes, level by level: its rows routed through its own splits, its
    row sample redrawn from the fit's seed."""
    n = codes_w.shape[1]
    samp = torch.from_numpy((np.random.default_rng(seed).uniform(size=n)
                             < rate).astype(np.float32)).to(codes_w.device)
    wt, wc = samp * treat_d, samp * (1 - treat_d)
    f = model.forest
    feat, bins, split = (getattr(f, k)[0] for k in ("feat", "bin",
                                                    "is_split"))
    idx = torch.zeros(n, dtype=torch.int64, device=codes_w.device)
    out = []
    for d in range(model.max_depth + 1):
        node = idx.to(torch.int32)
        for w in (wt, wc):
            out.append((2 ** d, node, torch.stack([w, y_d * w,
                                                   torch.zeros_like(w)])))
        if d == model.max_depth:
            break
        heap = (2 ** d - 1) + idx
        rf = feat[heap].to(torch.int64)
        code = codes_w.gather(0, rf[None, :])[0].to(torch.int32)
        idx = 2 * idx + ((code > bins[heap]) & split[heap]).to(torch.int64)
    return out, wt, wc


def _profile_calls(fn):
    """(wall s, device kernels, device busy s, B1 device ms) of fn() under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, b1 = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "hist_fixed_" in e.name:
            b1 += e.time_range.elapsed_us()
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, len(spans), busy / 1e6, b1 / 1e3


def uplift_path(dev, card):
    """Phase 35(c): UpliftDRF at its defaults on the Criteo-shaped frame;
    returns (record, model, frame, the `hist_factored_uplift` kernel
    entry)."""
    from h2o3_tpu_torch.estimators import H2OUpliftRandomForestEstimator
    from h2o3_tpu_torch.models import uplift as up
    from h2o3_tpu_torch.ops import hist_cuda, histogram, prng

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fr, region = make_criteo_uplift_like(UP_ROWS, 35)
    gen_s = time.perf_counter() - t0
    y = np.asarray(fr.vec("visit").data, np.float64)
    treat = np.asarray(fr.vec("treatment").data, np.float64)
    print(f"phase 35(c) frame (Criteo Uplift v2.1's shape): {UP_ROWS} rows "
          f"x {len(UP_NAMES)} features, treatment {treat.mean():.4f}, visit "
          f"{y.mean():.4f}, τ's region {region.mean():.4f} of rows; cut "
          f"from {CRITEO_ROWS} rows for the smoke's time; generated in "
          f"{gen_s:.3f} s", flush=True)
    bad = []
    c0 = kernel_counts()
    histogram.DISPATCH.clear()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    est = H2OUpliftRandomForestEstimator(treatment_column="treatment",
                                         seed=42, device=str(dev))
    model = est.train(y="visit", training_frame=fr).model
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    c1 = kernel_counts()
    fit_launches = {k: c1[k] - c0[k] for k in c1}
    dispatch = dict(histogram.DISPATCH)
    want_b1 = 2 * (UP_DEPTH + 1) * UP_TREES
    if fit_launches != dict(hist=want_b1, hist_rows=0, score=1, shap=0) \
            or dispatch != {"pallas_factored": want_b1}:
        bad.append(f"fit launches {fit_launches}, dispatch {dispatch}: "
                   f"want {want_b1} B1, no B2, one forest call (metrics)")
    t2 = time.perf_counter()
    u = model.predict(fr).vec("uplift_predict").numeric_np()
    pred_s = time.perf_counter() - t2
    pred_score = kernel_counts()["score"] - c1["score"]
    if pred_score != 1:
        bad.append(f"predict made {pred_score} forest calls, not 1")
    # each tree's root value against p_t − p_c of its own sampled rows, on
    # the host in f64 (the fit's row draws replayed from its seed)
    rng = np.random.default_rng(42)
    root = model.forest.value[:, 0].cpu().numpy().astype(np.float64)
    root_err = 0.0
    for t in range(model.ntrees_built):
        s = rng.uniform(size=UP_ROWS) < 0.632
        wt, wc = s * treat, s * (1 - treat)
        want = (y @ wt) / wt.sum() - (y @ wc) / wc.sum()
        root_err = max(root_err, abs(root[t] - want))
    if root_err > UP_ROOT_TOL:
        bad.append(f"a root value is {root_err:.3e} from p_t - p_c")
    m = model.training_metrics
    rand, _ = up.auuc(y, treat, np.random.default_rng(7).uniform(size=UP_ROWS))
    u_in, u_out = float(u[region].mean()), float(u[~region].mean())
    if not u_in > u_out or not m.auuc > rand:
        bad.append(f"uplift on τ's region {u_in:.5f} vs {u_out:.5f}, qini "
                   f"AUUC {m.auuc:.3f} vs a random ranking's {rand:.3f}")
    # tree 0's passes again: the deepest (L = 1024, treatment weights)
    # bit-equal to hist_plain_fixed, then all 22 timed
    codes_w = histogram.feature_major(
        torch.from_numpy(model.bm.codes).to(dev))
    y_d = torch.from_numpy(y.astype(np.float32)).to(dev)
    t_d = torch.from_numpy(treat.astype(np.float32)).to(dev)
    passes, wt_d, wc_d = _hist_passes(model, codes_w, y_d, t_d, 0.632, 42)
    L, node, vals = passes[-2]
    err, err_k, err_p = check_b1(codes_w, node, vals, L, UP_NBINS)
    rows = []
    for L, node, vals in passes:
        n_w = int((vals[0] != 0).sum())
        r = dict(L=L, weighted_rows=n_w)
        r["ms"] = time_ms_cold(lambda: hist_cuda.hist_build(
            codes_w, node, vals, L, UP_NBINS), reps=5, warmup=1)
        r["plain_ms"] = time_ms(lambda: hist_cuda.hist_plain(
            codes_w, node, vals, L, UP_NBINS), reps=3, warmup=1)
        r["library_ms"] = bm_library_ms(dev, codes_w, node, vals, L,
                                        UP_NBINS)
        r["bound_ms"], r["bytes"] = bound_ms_of(
            n_w, L, n_feat=len(UP_NAMES), nbins=UP_NBINS, n_rows=UP_ROWS)
        r["max_abs_err"] = float((hist_cuda.hist_build(
            codes_w, node, vals, L, UP_NBINS) - hist_cuda.hist_plain(
            codes_w, node, vals, L, UP_NBINS)).abs().max())
        rows.append(r)
    # one tree built again under the profiler: its launches and the
    # device's busy share of its wall
    edges = np.full((len(UP_NAMES), UP_NBINS - 2), np.inf, np.float32)
    for j, e in enumerate(model.bm.edges):
        edges[j, :min(len(e), UP_NBINS - 2)] = e[:UP_NBINS - 2]
    edges_d = torch.from_numpy(edges).to(dev)
    wall1, events, busy, b1_ms = _profile_calls(lambda: up.build_uplift_tree(
        codes_w, y_d, wt_d, wc_d, edges_d, max_depth=UP_DEPTH,
        nbins=UP_NBINS, min_rows=10.0, metric="KL", mtries=3,
        key=prng.PRNGKey(42)))
    del codes_w, passes
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    entry = dict(name="hist_factored_uplift", route="cuda",
                 source="h2o3_tpu_torch/csrc/hist.cu",
                 replaces="h2o3_tpu/ops/hist_pallas.py:103",
                 launches=fit_launches["hist"],
                 max_abs_err=max(r["max_abs_err"] for r in rows),
                 ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=tot["bound_ms"], bound_by="bytes",
                 library_ms=tot["library_ms"])
    ft = model.fit_timings
    rec = dict(card=card, rows=UP_ROWS, fit_s=fit_s, fit_timings=ft,
               predict_s=pred_s, fit_launches=fit_launches,
               trees=model.ntrees_built, root_err=root_err,
               uplift_region=u_in, uplift_rest=u_out, auuc_qini=float(m.auuc),
               auuc_random=rand, ate=float(m.ate),
               b1_deep_check=dict(L=1024, max_abs_err=err, f64_err=err_k,
                                  plain_f64_err=err_p),
               tree_profile=dict(wall_s=wall1, device_kernels=events,
                                 busy_s=busy, busy_share=busy / wall1,
                                 b1_device_ms=b1_ms),
               passes=[{k: r[k] for k in ("L", "weighted_rows", "ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms")} for r in rows])
    print(f"phase 35(c) on {card}: UpliftDRF {UP_ROWS} x {len(UP_NAMES)}, "
          f"{model.ntrees_built} trees, depth {UP_DEPTH}, fit {fit_s:.3f} s "
          f"= binning {ft['bin_s']:.3f} + upload {ft['h2d_s']:.3f} + tree "
          f"loop {ft['trees_s']:.3f} (row draws {ft['sample_s']:.3f}) + "
          f"metrics {ft['metrics_s']:.3f}; launches {json.dumps(fit_launches)}"
          f"; predict {pred_s:.3f} s (1 forest call); one tree again under "
          f"the profiler: {events} device kernels in {wall1:.4f} s, busy "
          f"{busy / wall1:.3f}, B1 {b1_ms:.3f} ms; B1 over tree 0's 22 "
          f"passes {tot['ms']:.4f} ms (plain {tot['plain_ms']:.4f}, "
          f"index_add_ {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}); "
          f"L=1024 bit-equal to hist_plain_fixed; roots within "
          f"{root_err:.2e} of p_t - p_c; uplift on τ's region {u_in:.5f} vs "
          f"{u_out:.5f}; qini AUUC {m.auuc:.3f} vs random {rand:.3f}; ATE "
          f"{m.ate:.5f}", flush=True)
    print("phase 35(c) record: " + json.dumps(rec), flush=True)
    PHASE35_WALLS["c"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 35(c): " + "; ".join(bad))
    return rec, model, fr, entry


def _eif_near_rows(scorer, X64: np.ndarray) -> np.ndarray:
    """Rows whose f64 walk through an EIF payload passes a node whose
    threshold lies within the f32 rounding of the live model's projection
    ((p + 2)·2^-24·Σ|x_j·d_j| + 2^-23·|thr|)."""
    a, depth = scorer.arrays, scorer.meta["depth"]
    dirs, thrs, splits = a["eif_dirs"], a["eif_thrs"], a["eif_splits"]
    N, p = X64.shape
    near = np.zeros(N, bool)
    for t in range(dirs.shape[0]):
        idx = np.zeros(N, np.int64)
        live = np.ones(N, bool)
        for d in range(depth):
            node = 2 ** d - 1 + idx
            live &= splits[t][node]
            prod = X64 * dirs[t][node]
            proj = prod.sum(1)
            thr = thrs[t][node].astype(np.float64)
            tol = ((p + 2) * 2.0 ** -24 * np.abs(prod).sum(1)
                   + 2.0 ** -23 * np.abs(thr))
            near |= live & (np.abs(proj - thr) <= tol)
            idx = np.where(live, 2 * idx + (proj > thr), idx)
    return near


def if_mojo_serving(dev, card, models):
    """Phase 35(d): each model saved and loaded, the numpy scorer against
    `predict` on UP_CHECK_ROWS rows within 1e-5, but for the rows within
    one f32 rounding of a threshold (counted); one batch of each served
    equal to `predict` with no fallback."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.models import isolation_forest as iso
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    t_phase = time.perf_counter()
    bad, out = [], {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_iso_") as d:
        for name, (model, fr) in models.items():
            sub = fr.take(np.arange(UP_CHECK_ROWS))
            t0 = time.perf_counter()
            scorer = mojo.load_model(mojo.save_model(model, d,
                                                     f"{name}.h2o3"))
            c0 = kernel_counts()
            got = _frame_matrix(scorer.predict(sub))
            c1 = kernel_counts()
            want = _frame_matrix(model.predict(sub))
            torch.cuda.synchronize()
            c2 = kernel_counts()
            diff = np.abs(got - want).max(axis=1)
            # the rows a threshold's f32 rounding may send another way:
            # IsolationForest's payload rounds its f64 thresholds, the EIF
            # and uplift scorers walk f64 rows where the live models walk
            # f32 ones
            X64 = np.column_stack([sub.vec(c).numeric_np() for c in model.x])
            if name == "isoforest":
                f32 = [(f, t.astype(np.float32).astype(np.float64), s, n)
                       for f, t, s, n in model.trees]
                near = (iso.forest_path_lengths(model.trees, X64,
                                                model.max_depth)
                        != iso.forest_path_lengths(f32, X64,
                                                   model.max_depth))
            elif name == "uplift":
                x32 = X64.astype(np.float32).astype(np.float64)
                near = (_frame_matrix(scorer.predict(X64))
                        != _frame_matrix(scorer.predict(x32)))[:, 0]
            else:
                near = _eif_near_rows(scorer, scorer._expand_dinfo(sub))
            off = diff > 1e-5
            out[name] = dict(max_abs_err_far=float(diff[~near].max()),
                             near_rows=int(near.sum()),
                             off_rows=int(off.sum()),
                             s=time.perf_counter() - t0)
            if (off & ~near).any():
                bad.append(f"{name}: MOJO {float(diff[~near].max()):.3e} "
                           f"from predict on {int((off & ~near).sum())} rows "
                           "no threshold's rounding explains")
            want_pred = dict(hist=0, hist_rows=0, score=int(name == "uplift"),
                             shap=0)
            if c1 != c0 or {k: c2[k] - c1[k] for k in c2} != want_pred:
                bad.append(f"{name}: launches {c0} -> MOJO {c1} -> predict "
                           f"{c2}")
    engine = ScoringEngine(ServingConfig())
    try:
        for name, (model, fr) in models.items():
            batch = fr.take(np.arange(100, 357))
            served = _frame_matrix(engine.score(f"iso_{name}", model, batch))
            diff = float(np.abs(served - _frame_matrix(
                model.predict(batch))).max())
            out[name]["served_max_abs_err"] = diff
            if diff > 0:
                bad.append(f"{name}: served {diff:.3e} from predict")
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    out["fallback_scores"] = snap["totals"]["fallback_scores"]
    if snap["totals"]["fallback_scores"] or snap["totals"]["errors"]:
        bad.append(f"serving {snap['totals']}")
    PHASE35_WALLS["d"] = time.perf_counter() - t_phase
    print(f"phase 35(d) on {card}: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 35(d): " + "; ".join(bad))
    return out


def if_small_checks(dev, card):
    """Phase 35(e): card against CPU on the CPU tests' small frames, with
    their tolerances (IF_SMALL_TOLS)."""
    from h2o3_tpu_torch.estimators import (
        H2OExtendedIsolationForestEstimator, H2OIsolationForestEstimator,
        H2OUpliftRandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame

    t_phase = time.perf_counter()
    tol = IF_SMALL_TOLS
    bad, out = [], {}

    def pair(cls, fr, **params):
        x = params.pop("x", None)
        y = params.pop("y", None)
        return [cls(device=d, **params).train(x=x, y=y,
                                              training_frame=fr).model
                for d in (str(dev), "cpu")]

    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(size=(500, 3)),
                        rng.normal(loc=8.0, size=(10, 3))])
    X[::37, 1] = np.nan
    fr = Frame.from_numpy(X)
    for params in (dict(ntrees=40, sample_size=128, seed=8),
                   dict(ntrees=15, sample_rate=0.3, max_depth=6, seed=3)):
        a, c = pair(H2OIsolationForestEstimator, fr, **params)
        same = all(np.array_equal(u, v) for ta, tc in zip(a.trees, c.trees)
                   for u, v in zip(ta, tc))
        err = float(np.abs(_frame_matrix(a.predict(fr))
                           - _frame_matrix(c.predict(fr))).max())
        key = "if_" + ("rate" if "sample_rate" in params else "size")
        out[key] = dict(trees_equal=same, path_err=err)
        if not same or err > tol["if_path"]:
            bad.append(f"{key}: {out[key]}")
    rng = np.random.default_rng(4)
    Y = np.concatenate([rng.normal(size=(500, 4)),
                        rng.normal(loc=8.0, size=(10, 4))])
    fr = Frame.from_numpy(Y)
    for ext in (0, 2, 3):
        a, c = pair(H2OExtendedIsolationForestEstimator, fr, ntrees=30,
                    sample_size=128, extension_level=ext, seed=9)
        same = (torch.equal(a.splits.cpu(), c.splits)
                and torch.equal(a.counts.cpu(), c.counts))
        terr = float((a.thrs.cpu() - c.thrs).abs().max())
        serr = float(np.abs(_frame_matrix(a.predict(fr))
                            - _frame_matrix(c.predict(fr))).max())
        out[f"eif_ext{ext}"] = dict(splits_counts_equal=same, thr_err=terr,
                                    score_err=serr)
        if not same or terr > tol["eif"] * max(1.0, float(c.thrs.abs().max())) \
                or serr > tol["eif"]:
            bad.append(f"eif ext {ext}: {out[f'eif_ext{ext}']}")
    rng = np.random.default_rng(3)
    n = 2000
    X = rng.normal(size=(n, 3))
    treat = rng.integers(0, 2, n)
    lift = np.where(X[:, 0] > 0, 0.4, 0.0) * treat
    yv = (rng.uniform(size=n) < (X[:, 1] > 0.5) * 0.2 + lift + 0.1).astype(int)
    g = rng.integers(0, 4, n)
    fr = Frame.from_dict(
        {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
         "g": np.asarray(list("abcd"), dtype=object)[g],
         "treatment": np.asarray(["control", "treatment"],
                                 dtype=object)[treat],
         "y": np.asarray(["0", "1"], dtype=object)[yv]},
        column_types={"g": "enum", "treatment": "enum", "y": "enum"})
    for metric in ("KL", "Euclidean", "ChiSquared"):
        a, c = pair(H2OUpliftRandomForestEstimator, fr,
                    x=["x0", "x1", "x2", "g"], y="y",
                    treatment_column="treatment", uplift_metric=metric,
                    ntrees=10, max_depth=5, seed=11)
        diff = sum(int((getattr(a.forest, f).cpu()
                        != getattr(c.forest, f)).sum())
                   for f in ("feat", "bin", "is_split"))
        verr = float((a.forest.value.cpu() - c.forest.value).abs().max())
        perr = float(np.abs(_frame_matrix(a.predict(fr))
                            - _frame_matrix(c.predict(fr))).max())
        out[f"uplift_{metric}"] = dict(nodes_differ=diff, value_err=verr,
                                       pred_err=perr)
        if diff or verr > 1e-6 or perr > tol["uplift_pred"]:
            bad.append(f"uplift {metric}: {out[f'uplift_{metric}']}")
    # 300 bins pad to B = 512: uint16 codes sent as int16, B1's int16
    # instance
    a, c = pair(H2OUpliftRandomForestEstimator, fr,
                x=["x0", "x1", "x2", "g"], y="y", treatment_column="treatment",
                nbins=300, ntrees=10, max_depth=5, seed=11)
    diff = sum(int((getattr(a.forest, f).cpu() != getattr(c.forest, f)).sum())
               for f in ("feat", "bin", "thr", "is_split", "value"))
    out["uplift_KL_300bins"] = dict(nbins_padded=a.bm.nbins,
                                    codes=str(a.bm.codes.dtype),
                                    nodes_differ=diff)
    if diff or a.bm.nbins != 512:
        bad.append(f"uplift 300 bins: {out['uplift_KL_300bins']}")
    PHASE35_WALLS["e"] = time.perf_counter() - t_phase
    print(f"phase 35(e) on {card}, card vs cpu (tolerances "
          f"{json.dumps(tol)}): " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 35(e): " + "; ".join(bad))
    return out


def anomaly_uplift_path(dev, card):
    """Phase 35: (a)-(e) in turn with every launch count set to 0 before
    (a) and read after (e); (f) the isolation forests and the MOJO
    scorers launched no hand-written kernel, the uplift fit B1 only.
    Returns the `hist_factored_uplift` kernel entry."""
    zero_counts()
    models, if_rec = if_paths(dev, card)
    after_ab = kernel_counts()
    up_rec, up_model, up_fr, entry = uplift_path(dev, card)
    mojo_rec = if_mojo_serving(dev, card, dict(
        isoforest=models["isoforest"], eif_ext0=models["eif_ext0"],
        eif_ext29=models["eif_ext29"], uplift=(up_model, up_fr)))
    del models, up_model, up_fr
    small = if_small_checks(dev, card)
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"phase 35(f): hand-written kernel launches after (a, b) "
          f"{json.dumps(after_ab)}, after (e) {json.dumps(counts)} (the "
          "uplift fit's, its predict and metrics, the comparison and timing "
          "launches of (c), the served uplift batch and (e)'s card fits)",
          flush=True)
    if any(after_ab.values()) or counts["hist_rows"] or counts["shap"]:
        raise AssertionError(f"phase 35(f): a kernel ran where none "
                             f"should: {after_ab} then {counts}")
    return dict(iforest=if_rec, uplift=up_rec, mojo=mojo_rec,
                small=small), entry


# phase 36: NaiveBayes on Covertype's shape (a), GAM on Airlines' shape
# (b), isotonic regression calibrating (b)'s holdout (c), ANOVA GLM on
# (b)'s frame cut to ANOVA_ROWS (d), ModelSelection's maxr on a frame of
# the prostate columns of H2O's ModelSelection example (e), MOJOs and
# serving (f), card vs CPU on the CPU tests' small frames (g); (h) none of
# them launches a hand-written kernel
GAM_ROWS, GAM_HOLDOUT = 1_000_000, 200_000
GAM36 = dict(family="binomial", gam_columns=["DepTime", "Distance"],
             num_knots=[10, 10])
GAM_X = ["DepTime", "Distance", "Origin", "Dest", "Month", "DayOfWeek"]
# (b)'s bars: the holdout AUC within GAM_AUC_TOL of the generator's own
# probabilities' AUC, and above a GLM's on the same terms, all linear, by
# GAM_GLM_MARGIN (CPU rehearsals with a 100,000-row holdout: 0.0288 at
# 100,000 training rows, 0.0291 at 1,000,000; PERF.md §6)
GAM_AUC_TOL, GAM_GLM_MARGIN = 0.005, 0.01
ANOVA_ROWS = 30_000             # cut from GAM_ROWS for the phase's time
ANOVA_X = ["DepTime", "DayOfWeek", "Month"]
MS_ROWS, MS_MAX_P = 100_000, 7
MS_NAMES = ["AGE", "RACE", "CAPSULE", "DCAPS", "PSA", "VOL", "DPROS"]
MS_TRUE = ("CAPSULE", "DPROS", "PSA")
MS_R2_TOL = 1e-6
NB_MEAN_TOL = 1e-5
SMALL36_TOLS = dict(nb_moment=1e-6, nb_prob=1e-6, iso=0.0, gam=2e-4,
                    gam_ridge=1e-5, anova_active=1e-4, anova_inactive=1e-6,
                    ms_r2=1e-6, ms_coef=1e-4)
CHECK36_ROWS = 2_000
PHASE36_WALLS: dict = {}


def make_airlines_gam_like(n: int, seed: int):
    """`make_airlines_like`'s columns (DepTime, Distance, Origin and Dest of
    100 levels, Month, DayOfWeek) with a logit that keeps a linear DepTime
    part and a DayOfWeek term and adds a smooth bump in DepTime around
    16:00 (sd ≈ 7 hours), which a spline fits and a line does not. (A
    narrower bump, sd ≈ 3 hours, leaves the GAM's holdout AUC 0.006 below
    the generator's at 1M rows: the penalty scales with the Gram, so its
    smoothing does not fade with n; PERF.md §6.) Returns (frame, the
    generator's P(YES) per row, the 0/1 labels)."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    dep = rng.integers(0, 2400, n).astype(np.float64)
    dist = np.abs(rng.normal(800, 500, n))
    origin = rng.integers(0, 100, n)
    dest = rng.integers(0, 100, n)
    month = rng.integers(0, 12, n)
    dow = rng.integers(0, 7, n)
    eff = (0.0003 * (dep - 1200) + 1.5 * np.exp(-((dep - 1600) / 600) ** 2)
           + 0.4 * (origin % 7 == 0) - 0.3 * (dest % 11 == 0)
           + 0.8 * (dow >= 5) - 0.4)
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


def make_prostate_like(n: int, seed: int):
    """The columns of H2O's ModelSelection example (prostate.csv: AGE,
    RACE, CAPSULE, DCAPS, PSA, VOL, DPROS, response GLEASON), numeric as
    the example reads them, drawn with the dataset's ranges; GLEASON
    depends linearly on CAPSULE, DPROS and PSA only."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    cols = dict(
        AGE=np.round(rng.normal(66, 6.5, n)),
        RACE=rng.choice(3, n, p=[0.01, 0.9, 0.09]).astype(np.float64),
        CAPSULE=(rng.random(n) < 0.4).astype(np.float64),
        DCAPS=1.0 + (rng.random(n) < 0.1),
        PSA=np.round(rng.lognormal(2.2, 1.0, n), 1),
        VOL=np.where(rng.random(n) < 0.5, 0.0,
                     np.round(rng.gamma(2.0, 12.0, n), 1)),
        DPROS=rng.integers(1, 5, n).astype(np.float64))
    cols["GLEASON"] = (4.6 + 0.9 * cols["CAPSULE"] + 0.35 * cols["DPROS"]
                       + 0.02 * cols["PSA"] + rng.normal(0, 0.7, n))
    return Frame.from_dict(cols)


def covtype_nb_frame():
    """Phase 14's Covertype-shaped training frame with the wilderness area
    and the soil type as two enum columns (4 and 40 levels) recovered from
    their one-hots."""
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_covtype_like(COV_ROWS, 5)
    cols = {f"cont{i}": X[:, i] for i in range(10)}
    cols["wild"] = np.char.add("W", X[:, 10:14].argmax(1).astype(str))
    cols["soil"] = np.char.add("S", X[:, 14:54].argmax(1).astype(str))
    cols["cover"] = np.char.add("C", y.astype(str))
    return Frame.from_dict(cols, column_types=dict(
        wild="enum", soil="enum", cover="enum")), y


def _auc(y, p) -> float:
    from h2o3_tpu_torch.models.metrics import auc_exact

    return float(auc_exact(np.asarray(y, np.float64), np.asarray(p, np.float64)))


def nb_covtype_path(dev, card):
    """Phase 36(a): NaiveBayes at its defaults on the Covertype-shaped
    frame (581,012 rows, 10 numeric and 2 enum columns, 7 classes)."""
    from h2o3_tpu_torch.estimators import H2ONaiveBayesEstimator

    t_phase = time.perf_counter()
    fr, y = covtype_nb_frame()
    bad = []
    t0 = time.perf_counter()
    model = H2ONaiveBayesEstimator(device=str(dev)).train(
        y="cover", training_frame=fr).model
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = model.predict(fr)
    predict_s = time.perf_counter() - t0
    again = H2ONaiveBayesEstimator(device=str(dev)).train(
        y="cover", training_frame=fr).model
    K = len(model.domain)
    codes = np.asarray(fr.vec("cover").data)
    counts = np.bincount(codes, minlength=K).astype(np.float64)
    priors_ok = model.priors.tobytes() == (counts / counts.sum()).tobytes()
    mean_err, sd_gap = 0.0, 0.0
    for name, st in model.num_stats.items():
        col = fr.vec(name).numeric_np()
        for k in range(K):
            xs = col[codes == k]
            m = xs.sum() / len(xs)                      # two-pass f64
            sd = np.sqrt(((xs - m) ** 2).sum() / (len(xs) - 1))
            mean_err = max(mean_err, abs(st[k, 0] - m) / abs(m))
            sd_gap = max(sd_gap, abs(st[k, 1] - sd) / sd)
    tables_ok = True
    for name, (tab, dom) in model.cat_tables.items():
        c = np.asarray(fr.vec(name).data)
        L = len(dom)
        cnt = np.bincount(codes * L + c, minlength=K * L).reshape(K, L)
        want = cnt / (cnt.sum(axis=1, keepdims=True) + 1e-300)
        want = np.maximum(want, 0.001 * 1e-3)
        tables_ok &= tab.tobytes() == want.tobytes()
    same = all(again.num_stats[n].tobytes() == model.num_stats[n].tobytes()
               for n in model.num_stats)
    prior_ll = float(-np.log(model.priors[codes]).mean())
    ll = float(model.training_metrics.logloss)
    probs = np.column_stack([pred.vec(c).numeric_np() for c in model.domain])
    rec = dict(rows=fr.nrow, fit_s=fit_s, fit_split=model.fit_timings,
               predict_s=predict_s, priors_equal=priors_ok,
               mean_max_rel_err=mean_err, sd_max_rel_gap=sd_gap,
               tables_equal=bool(tables_ok), repeat_fit_bit_equal=same,
               logloss=ll, priors_logloss=prior_ll,
               accuracy=float((probs.argmax(1) == codes).mean()))
    if not priors_ok:
        bad.append("priors differ from bincount / n")
    if mean_err > NB_MEAN_TOL:
        bad.append(f"class mean {mean_err:.3e} from the f64 two-pass mean")
    if not tables_ok:
        bad.append("a table differs from the host recount")
    if not same:
        bad.append("a second fit on the card differs")
    if not ll < prior_ll:
        bad.append(f"logloss {ll} not below the priors' {prior_ll}")
    PHASE36_WALLS["a"] = time.perf_counter() - t_phase
    print(f"phase 36(a) NaiveBayes on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 36(a): " + "; ".join(bad))
    return rec, model, fr


def gam_airlines_path(dev, card, rows=GAM_ROWS, holdout=GAM_HOLDOUT):
    """Phase 36(b): the binomial GAM with DepTime and Distance as splines
    (10 knots each) and Origin, Dest, Month and DayOfWeek linear, on the
    Airlines-shaped frame; a GLM on the same terms, all linear, beside it."""
    from h2o3_tpu_torch.estimators import (H2OGeneralizedAdditiveEstimator,
                                           H2OGeneralizedLinearEstimator)

    t_phase = time.perf_counter()
    fr, _, _ = make_airlines_gam_like(rows, 11)
    fh, p_h, y_h = make_airlines_gam_like(holdout, 12)
    tf32_off()
    bad = []
    t0 = time.perf_counter()
    model = H2OGeneralizedAdditiveEstimator(device=str(dev), **GAM36).train(
        x=GAM_X, y="IsDepDelayed", training_frame=fr).model
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1 = model.predict(fh).vec("YES").numeric_np()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    glm = H2OGeneralizedLinearEstimator(
        family="binomial", lambda_=0.0, device=str(dev)).train(
        x=GAM_X, y="IsDepDelayed", training_frame=fr).model
    glm_s = time.perf_counter() - t0
    auc, auc_gen = _auc(y_h, p1), _auc(y_h, p_h)
    auc_glm = _auc(y_h, glm.predict(fh).vec("YES").numeric_np())
    rec = dict(rows=rows, holdout=holdout, fit_s=fit_s,
               fit_split=model.fit_timings, iterations=model.iterations,
               converged=model.converged,
               gram_ms=[round(g, 3) for g in model.gram_ms],
               design_cols=len(model.beta), predict_s=predict_s,
               holdout_auc=auc, generator_auc=auc_gen, glm_auc=auc_glm,
               glm_fit_s=glm_s, margin_bar=GAM_GLM_MARGIN)
    if not model.converged:
        bad.append(f"IRLS did not stop on beta_epsilon in "
                   f"{model.iterations} iterations")
    if abs(auc - auc_gen) > GAM_AUC_TOL:
        bad.append(f"holdout AUC {auc} vs the generator's {auc_gen}")
    if not auc > auc_glm + GAM_GLM_MARGIN:
        bad.append(f"holdout AUC {auc} not above the GLM's {auc_glm} "
                   f"by {GAM_GLM_MARGIN}")
    PHASE36_WALLS["b"] = time.perf_counter() - t_phase
    print(f"phase 36(b) GAM on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 36(b): " + "; ".join(bad))
    return rec, model, fr, fh, p1, y_h


def _pools(tx, ty):
    """The PAV pools from the knots: runs of equal y, each (x_lo, x_hi, y)."""
    out, i = [], 0
    while i < len(tx):
        j = i
        while j + 1 < len(tx) and ty[j + 1] == ty[i]:
            j += 1
        out.append((tx[i], tx[j], ty[i]))
        i = j + 1
    return out


def isotonic_calibration_path(dev, card, p1, y):
    """Phase 36(c): isotonic regression calibrating (b)'s holdout p1
    against its labels, under out_of_bounds "clip" and "NA", and on fresh
    rows outside the range."""
    from h2o3_tpu_torch.estimators import H2OIsotonicRegressionEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    t_phase = time.perf_counter()
    fr = Frame.from_dict({"p1": p1, "label": y.astype(np.float64)})
    x = fr.vec("p1").numeric_np()       # the frame's values, as fitted
    bad, out, models = [], {}, {}
    for oob in ("clip", "NA"):
        t0 = time.perf_counter()
        m = H2OIsotonicRegressionEstimator(
            device=str(dev), out_of_bounds=oob).train(
            x=["p1"], y="label", training_frame=fr).model
        fit_s = time.perf_counter() - t0
        tx, ty = m.thresholds_x, m.thresholds_y
        rising = bool(np.all(np.diff(tx) > 0) and np.all(np.diff(ty) >= 0))
        err = 0.0
        for lo, hi, v in _pools(tx, ty):
            sel = (x >= lo) & (x <= hi)
            err = max(err, abs(y[sel].mean() - v))
        q = np.array([tx[0] - 0.01, -1.0, tx[-1] + 0.01, 2.0, np.nan])
        s = m._score(q)
        want = ([ty[0], ty[0], ty[-1], ty[-1]] if oob == "clip"
                else [np.nan] * 4)
        oob_ok = bool(np.array_equal(s[:4], np.asarray(want), equal_nan=True)
                      and np.isnan(s[4]))
        t0 = time.perf_counter()
        m.predict(fr)
        out[oob] = dict(knots=len(tx), pools=len(_pools(tx, ty)),
                        fit_s=fit_s, fit_split=m.fit_timings,
                        predict_s=time.perf_counter() - t0,
                        knots_monotone=rising, pool_mean_max_err=err,
                        out_of_range_ok=oob_ok)
        if not rising:
            bad.append(f"{oob}: knots not monotone")
        if err > 1e-12:
            bad.append(f"{oob}: a pool's value {err:.3e} from its rows' mean")
        if not oob_ok:
            bad.append(f"{oob}: out-of-range rows gave {s}")
        models[oob] = m
    PHASE36_WALLS["c"] = time.perf_counter() - t_phase
    print(f"phase 36(c) isotonic regression on {card}: " + json.dumps(out),
          flush=True)
    if bad:
        raise AssertionError("phase 36(c): " + "; ".join(bad))
    return out, models["clip"], fr


def anova_path(dev, card, fr):
    """Phase 36(d): ANOVA GLM (binomial, highest_interaction_term 2) on
    DepTime, DayOfWeek and Month of (b)'s frame cut to ANOVA_ROWS: six
    terms, eight GLM fits."""
    from h2o3_tpu_torch.estimators import H2OANOVAGLMEstimator

    t_phase = time.perf_counter()
    sub = fr.take(np.arange(ANOVA_ROWS))
    tf32_off()
    t0 = time.perf_counter()
    model = H2OANOVAGLMEstimator(
        family="binomial", highest_interaction_term=2, device=str(dev)).train(
        x=ANOVA_X, y="IsDepDelayed", training_frame=sub).model
    fit_s = time.perf_counter() - t0
    width = {c: (1 if sub.vec(c).type != "enum" else sub.vec(c).nlevels - 1)
             for c in ANOVA_X}
    bad = []
    table = {r["term"]: r for r in model._table}
    for r in model._table:
        want = int(np.prod([width[c] for c in r["term"].split(":")]))
        if r["df"] != want:
            bad.append(f"{r['term']}: df {r['df']}, expected {want}")
        if not (np.isfinite(r["deviance"]) and r["deviance"] >= 0):
            bad.append(f"{r['term']}: deviance {r['deviance']}")
    for t in ("DepTime", "DayOfWeek"):
        if not table[t]["p_value"] < 1e-6:
            bad.append(f"{t}: p {table[t]['p_value']}")
    print(f"phase 36(d) cut: {ANOVA_ROWS} rows of (b)'s {GAM_ROWS}",
          flush=True)
    rec = dict(rows=ANOVA_ROWS, fit_s=fit_s, glm_fits=len(model.fit_walls),
               fit_walls={k: round(v, 4) for k, v in model.fit_walls},
               table=[{k: r[k] for k in ("term", "df", "deviance", "p_value")}
                      for r in model._table])
    PHASE36_WALLS["d"] = time.perf_counter() - t_phase
    print(f"phase 36(d) ANOVA GLM on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 36(d): " + "; ".join(bad))
    return rec, model, sub


def _ls_r2(X: np.ndarray, y: np.ndarray) -> float:
    """Host f64 least-squares R² with an intercept."""
    A = np.column_stack([X, np.ones(len(y))])
    b = np.linalg.lstsq(A, y, rcond=None)[0]
    r = y - A @ b
    return float(1 - (r @ r) / ((y - y.mean()) @ (y - y.mean())))


def modelselection_path(dev, card):
    """Phase 36(e): ModelSelection's maxr (gaussian, up to 7 predictors) on
    MS_ROWS rows of the prostate columns."""
    import itertools

    from h2o3_tpu_torch.estimators import H2OModelSelectionEstimator

    t_phase = time.perf_counter()
    fr = make_prostate_like(MS_ROWS, 21)
    tf32_off()
    t0 = time.perf_counter()
    model = H2OModelSelectionEstimator(
        mode="maxr", family="gaussian", max_predictor_number=MS_MAX_P,
        device=str(dev)).train(x=MS_NAMES, y="GLEASON",
                               training_frame=fr).model
    fit_s = time.perf_counter() - t0
    cols = {c: fr.vec(c).numeric_np() for c in MS_NAMES}
    y = fr.vec("GLEASON").numeric_np()
    bad = []
    preds = model.get_best_model_predictors()
    r2s = model.get_best_r2_values()
    ls, best = [], []
    for size, (pr, r2) in enumerate(zip(preds, r2s), start=1):
        ls.append(_ls_r2(np.column_stack([cols[c] for c in pr]), y))
        if abs(r2 - ls[-1]) > MS_R2_TOL:
            bad.append(f"size {size}: R² {r2} vs host {ls[-1]}")
        if size <= 3:
            best.append(max(_ls_r2(np.column_stack([cols[c] for c in s]), y)
                            for s in itertools.combinations(MS_NAMES, size)))
            if abs(r2 - best[-1]) > MS_R2_TOL:
                bad.append(f"size {size}: R² {r2} vs best subset {best[-1]}")
    if set(preds[2]) != set(MS_TRUE):
        bad.append(f"the first three predictors are {preds[2]}")
    rec = dict(rows=MS_ROWS, fit_s=fit_s, glm_fits=model.n_glm_fits,
               ms_a_fit=fit_s / max(model.n_glm_fits, 1),
               predictors=preds, r2=r2s, host_r2=ls, best_subset_r2=best)
    PHASE36_WALLS["e"] = time.perf_counter() - t_phase
    print(f"phase 36(e) ModelSelection on {card}: " + json.dumps(rec),
          flush=True)
    if bad:
        raise AssertionError("phase 36(e): " + "; ".join(bad))
    return rec, model, fr


def glm_family_mojo_serving(dev, card, models):
    """Phase 36(f): NaiveBayes, isotonic and GAM saved and loaded, each
    numpy scorer against `predict` on CHECK36_ROWS rows (probabilities
    within 1e-5, isotonic within 1e-12); ANOVA GLM and ModelSelection
    refuse export; one batch of each of the five served equal to
    `predict` with no fallback."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    t_phase = time.perf_counter()
    bad, out = [], {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_glmfam_") as d:
        for name, tol in (("naivebayes", 1e-5), ("isotonic", 1e-12),
                          ("gam", 1e-5)):
            model, fr = models[name]
            sub = fr.take(np.arange(min(CHECK36_ROWS, fr.nrow)))
            scorer = mojo.load_model(mojo.save_model(model, d, f"{name}.h2o3"))
            got = _frame_matrix(scorer.predict(sub))
            want = _frame_matrix(model.predict(sub))
            err = float(np.nan_to_num(np.abs(got - want)).max())
            nan_same = bool(np.array_equal(np.isnan(got), np.isnan(want)))
            out[name] = dict(mojo_max_abs_err=err, nan_same=nan_same)
            if err > tol or not nan_same:
                bad.append(f"{name}: MOJO {err:.3e} from predict")
        for name in ("anovaglm", "modelselection"):
            try:
                mojo.save_model(models[name][0], d, f"{name}.h2o3")
                bad.append(f"{name}: exported")
            except TypeError:
                out[name] = dict(export="TypeError")
    engine = ScoringEngine(ServingConfig())
    try:
        for name, (model, fr) in models.items():
            batch = fr.take(np.arange(100, 357))
            served = _frame_matrix(engine.score(f"glmfam_{name}", model, batch))
            want = _frame_matrix(model.predict(batch))
            diff = float(np.nan_to_num(np.abs(served - want)).max())
            out[name]["served_max_abs_err"] = diff
            if diff > 1e-6:
                bad.append(f"{name}: served {diff:.3e} from predict")
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    out["fallback_scores"] = snap["totals"]["fallback_scores"]
    if snap["totals"]["fallback_scores"] or snap["totals"]["errors"]:
        bad.append(f"serving {snap['totals']}")
    PHASE36_WALLS["f"] = time.perf_counter() - t_phase
    print(f"phase 36(f) on {card}: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 36(f): " + "; ".join(bad))
    return out


def _grid16(X):
    return np.clip(np.round(X * 16) / 16, -8, 8)


def glm_family_small_checks(dev, card):
    """Phase 36(g): card against CPU on the CPU tests' small frames
    (tests/test_torch_naive_bayes_isotonic.py, test_torch_gam_family.py),
    with their tolerances (SMALL36_TOLS)."""
    from h2o3_tpu_torch.estimators import (
        H2OANOVAGLMEstimator, H2OGeneralizedAdditiveEstimator,
        H2OIsotonicRegressionEstimator, H2OModelSelectionEstimator,
        H2ONaiveBayesEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.anovaglm import _deviance

    t_phase = time.perf_counter()
    tol = SMALL36_TOLS
    bad, out = [], {}

    def pair(cls, fr, x=None, y="y", **params):
        return [cls(device=d, **params).train(x=x, y=y,
                                              training_frame=fr).model
                for d in (str(dev), "cpu")]

    # NaiveBayes: three classes on numeric columns; binary with enums
    rng = np.random.default_rng(0)
    yc = rng.integers(0, 3, 900)
    X = _grid16(rng.normal(size=(900, 4)) + yc[:, None] * [1.0, -0.5, 0.3, 0])
    X[::13, 2] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.asarray(list("abc"), dtype=object)[yc]
    nb_num = Frame.from_dict(cols, column_types={"y": "enum"})
    rng = np.random.default_rng(0)
    yb = rng.integers(0, 2, 900)
    X = _grid16(rng.normal(size=(900, 2)) * 2 + yb[:, None] * 2.0)
    g = np.where(rng.uniform(size=900) < 0.7, yb * 2, rng.integers(0, 4, 900))
    nb_cat = Frame.from_dict(
        {"x0": X[:, 0], "x1": X[:, 1],
         "g": np.asarray(list("pqrs"), dtype=object)[g],
         "h": np.asarray(list("uvw"), dtype=object)[rng.integers(0, 3, 900)],
         "y": np.asarray(["no", "yes"], dtype=object)[yb]},
        column_types={"g": "enum", "h": "enum", "y": "enum"})
    for key, fr, params in (("nb_numeric", nb_num, {}),
                            ("nb_categorical", nb_cat, dict(laplace=1.0))):
        a, c = pair(H2ONaiveBayesEstimator, fr, **params)
        merr = max(float(np.abs(a.num_stats[n] - c.num_stats[n]).max()
                         / np.abs(c.num_stats[n]).max()) for n in c.num_stats)
        teq = all(a.cat_tables[n][0].tobytes() == c.cat_tables[n][0].tobytes()
                  for n in c.cat_tables)
        perr = float(np.abs(_frame_matrix(a.predict(fr))[:, 1:]
                            - _frame_matrix(c.predict(fr))[:, 1:]).max())
        out[key] = dict(moment_rel_err=merr, tables_equal=teq, prob_err=perr)
        if merr > tol["nb_moment"] or not teq or perr > tol["nb_prob"]:
            bad.append(f"{key}: {out[key]}")
    # isotonic regression with weights, ties and NaNs
    rng = np.random.default_rng(1)
    xi = np.round(rng.uniform(-2, 2, 600), 2)
    yi = np.tanh(xi) + rng.normal(0, 0.4, 600)
    xi[::31] = np.nan
    fr = Frame.from_dict({"x": xi, "y": yi, "w": rng.uniform(0.2, 3.0, 600)})
    q = np.concatenate([np.linspace(-2.5, 2.5, 401), [np.nan]])
    for oob in ("NA", "clip"):
        a, c = pair(H2OIsotonicRegressionEstimator, fr, x=["x"],
                    out_of_bounds=oob, weights_column="w")
        same = (a.thresholds_x.tobytes() == c.thresholds_x.tobytes()
                and a.thresholds_y.tobytes() == c.thresholds_y.tobytes()
                and np.array_equal(a._score(q), c._score(q), equal_nan=True))
        out[f"isotonic_{oob}"] = dict(equal=same)
        if not same:
            bad.append(f"isotonic {oob}: card and cpu differ")
    # GAM, gaussian and binomial at the defaults, and with a ridge
    for fam, gtol, extra in (("gaussian", tol["gam"], {}),
                             ("binomial", tol["gam"], {}),
                             ("binomial", tol["gam_ridge"],
                              dict(num_knots=8, scale=[0.5], lambda_=1e-4))):
        rng = np.random.default_rng(3)
        x = rng.uniform(-3, 3, 800)
        z = rng.normal(size=800)
        gg = rng.integers(0, 3, 800)
        eta = np.sin(x) * 2 + 0.5 * z + 0.4 * (gg == 1)
        cols = {"x": x, "z": z, "g": np.asarray(list("abc"), dtype=object)[gg]}
        types = {"g": "enum"}
        if fam == "gaussian":
            cols["y"] = eta + rng.normal(0, 0.1, 800)
        else:
            yy = (rng.uniform(size=800) < 1 / (1 + np.exp(-1.5 * eta)))
            cols["y"] = np.asarray(["n", "p"], dtype=object)[yy.astype(int)]
            types["y"] = "enum"
        fr = Frame.from_dict(cols, column_types=types)
        params = dict(dict(gam_columns=["x"], num_knots=[10], family=fam),
                      **extra)
        a, c = pair(H2OGeneralizedAdditiveEstimator, fr, x=["x", "z", "g"],
                    **params)
        same = all(ka.tobytes() == kc.tobytes() and ca.tobytes() == cc.tobytes()
                   for (_, ka, ca), (_, kc, cc) in zip(a.gam_spec, c.gam_spec))
        perr = float(np.abs(a._score(fr) - c._score(fr)).max())
        key = f"gam_{fam}" + ("_ridge" if extra else "")
        out[key] = dict(knots_centres_equal=same, pred_err=perr)
        if not same or perr > gtol:
            bad.append(f"{key}: {out[key]}")
    # ANOVA GLM: only `a` matters
    rng = np.random.default_rng(5)
    a_, b_ = rng.normal(size=500), rng.normal(size=500)
    cc = rng.integers(0, 3, 500)
    fr = Frame.from_dict({"a": a_, "b": b_,
                          "c": np.asarray(list("xyz"), dtype=object)[cc],
                          "y": 2.0 * a_ + rng.normal(0, 0.5, 500)},
                         column_types={"c": "enum"})
    a, c = pair(H2OANOVAGLMEstimator, fr, x=["a", "b", "c"],
                family="gaussian")
    yv = fr.vec("y").numeric_np()
    dev_full = _deviance("gaussian", yv, c._full.model._score(
        c._as_design(fr)), np.ones(len(yv)))
    errs = {}
    ok = [r["df"] for r in a._table] == [r["df"] for r in c._table]
    for ra, rc in zip(a._table, c._table):
        d = abs(ra["deviance"] - rc["deviance"])
        lim = (tol["anova_active"] * rc["deviance"] if rc["term"] == "a"
               else tol["anova_inactive"] * dev_full)
        errs[rc["term"]] = d
        ok &= ra["term"] == rc["term"] and d <= lim
    out["anova"] = dict(ok=bool(ok), deviance_err=errs)
    if not ok:
        bad.append(f"anova: {out['anova']}")
    # ModelSelection, maxr and backward
    rng = np.random.default_rng(6)
    X = rng.normal(size=(400, 4))
    cols = {f"x{i + 1}": X[:, i] for i in range(4)}
    cols["y"] = (3 * X[:, 0] + 1.5 * X[:, 1] + 0.6 * X[:, 3]
                 + rng.normal(0, 0.3, 400))
    fr = Frame.from_dict(cols)
    for mode in ("maxr", "backward"):
        a, c = pair(H2OModelSelectionEstimator, fr, x=list(cols)[:4],
                    mode=mode, max_predictor_number=4, family="gaussian")
        same = a.get_best_model_predictors() == c.get_best_model_predictors()
        rerr = max(abs(u - v) for u, v in zip(a.get_best_r2_values(),
                                             c.get_best_r2_values()))
        cerr = max(abs(a.coef(s)[k] - c.coef(s)[k])
                   for s in range(1, 5) for k in c.coef(s))
        out[f"ms_{mode}"] = dict(predictors_equal=same, r2_err=rerr,
                                 coef_err=cerr)
        if not same or rerr > tol["ms_r2"] or cerr > tol["ms_coef"]:
            bad.append(f"ms {mode}: {out[f'ms_{mode}']}")
    PHASE36_WALLS["g"] = time.perf_counter() - t_phase
    print(f"phase 36(g) on {card}, card vs cpu (tolerances "
          f"{json.dumps(tol)}): " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 36(g): " + "; ".join(bad))
    return out


def glm_family_path(dev, card):
    """Phase 36: (a)-(g) in turn with every launch count set to 0 before
    (a) and read after (g); (h) none of them launched a hand-written
    kernel."""
    zero_counts()
    nb_rec, nb_model, nb_fr = nb_covtype_path(dev, card)
    nb_check = nb_fr.take(np.arange(0, COV_ROWS, 97))
    del nb_fr
    gam_rec, gam_model, g_fr, g_fh, p1, y_h = gam_airlines_path(dev, card)
    iso_rec, iso_model, iso_fr = isotonic_calibration_path(dev, card, p1, y_h)
    an_rec, an_model, an_fr = anova_path(dev, card, g_fr)
    del g_fr
    ms_rec, ms_model, ms_fr = modelselection_path(dev, card)
    mojo_rec = glm_family_mojo_serving(dev, card, dict(
        naivebayes=(nb_model, nb_check),
        isotonic=(iso_model, iso_fr), gam=(gam_model, g_fh),
        anovaglm=(an_model, an_fr), modelselection=(ms_model, ms_fr)))
    del nb_check, g_fh
    small = glm_family_small_checks(dev, card)
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"phase 36(h): hand-written kernel launches after (a)-(g) "
          f"{json.dumps(counts)}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"phase 36(h): a kernel ran: {counts}")
    return dict(naivebayes=nb_rec, gam=gam_rec, isotonic=iso_rec,
                anova=an_rec, modelselection=ms_rec, mojo=mojo_rec,
                small=small)


# phase 37: CoxPH on the Stanford heart transplant data's shape (a), PSVM on
# the splice data's shape (b), RuleFit on config 1's HIGGS shape (c), MOJOs
# and serving (d), card vs CPU on the CPU tests' small frames (e); (f) only
# RuleFit's trees launch a hand-written kernel (B1)
HEART_ROWS = 500_000            # the reference's envelope, not the 172 rows
HEART_X = ["age", "year", "surgery", "transplant"]
# the generator's log hazard ratios (the published fit of the heart data is
# near age 0.03, year -0.15, surgery -0.64)
HEART_BETA = dict(age=0.03, year=-0.15, surgery=-0.6, transplant=-0.3)
HEART_SE_BAR = 4.0              # Efron β within 4 standard errors
CONC_CHECK_ROWS = 20_000
SPLICE_ROWS, SPLICE_POS = 100_000, 60   # the reference's envelope
PSVM37 = dict(gamma=0.01, rank_ratio=0.1, disable_training_metrics=False)
# (b)'s bar: the gaussian kernel's training AUC above the linear kernel's by
# PSVM_AUC_MARGIN (CPU rehearsal at 10,000 rows, PERF.md §6)
PSVM_AUC_MARGIN = 0.1
# the reference's Adam (constant rate 0.05, a 1e-7 relative stop on the f32
# loss) runs to its bound of 1000 steps from 30,000 splice-shaped rows up,
# in both packages (CPU rehearsal, PERF.md §6): the gaussian fit must then
# have run exactly that bound and still be descending at its last step
# cut from HIGGS' 11,000,000 (100,000 rows took 81.7 s, 50,000 66.0 s on an
# H100 at 700 W: the lasso path, most of the wall, barely moves with rows)
RF37_ROWS, RF37_HOLDOUT = 50_000, 50_000
RF37 = dict(max_num_rules=100, seed=42)
# (c)'s bar: the holdout AUC above a lasso GLM's on the 28 linear terms by
# RF_AUC_MARGIN (CPU rehearsal, PERF.md §6)
RF_AUC_MARGIN = 0.015
CHECK37_ROWS = 2_000
# 37(e)'s RuleFit pairs (PERF.md §4): the regression's trees, the CV's
# folds, trees and rows (its lasso path's iterations, most of a fit's
# time, fall with the rows: 3.24 s of GLM at 600 rows and 1.48 s at 300
# in the CPU fit)
RF_SMALL_TREES, RF_SMALL_FOLDS, RF_SMALL_CV_TREES = 4, 2, 2
RF_SMALL_CV_ROWS = 300
SMALL37_TOLS = dict(cox_beta=1e-5, cox_se=1e-5, psvm_decision=5e-3,
                    psvm_auc=1e-3, psvm_svs=5, rf_coef=5e-3, rf_pred=1e-4,
                    cv_cox=1e-4, cv_psvm=5e-3, cv_rf=1e-4)
PHASE37_WALLS: dict = {}


def make_heart_like(n_rows: int, seed: int):
    """Counting-process rows with the columns of H2O's CoxPH example (the
    Stanford heart transplant data: start, stop, event, age, year,
    surgery, transplant). Each subject has one (0, stop] row, or two when
    a transplant comes first: (0, wait] with transplant 0 and (wait, stop]
    with transplant 1. Hazard exp(HEART_BETA·x)/1500 a day, transplant
    waits Exp(300 days) for 65 % of subjects, censoring U(1, 7300) days,
    times in whole days (tie groups of several events); age (years from
    48) and year (of acceptance) on a 1/16 grid, exact in f32. Returns the
    frame's columns."""
    rng = np.random.default_rng(seed)
    n_sub = int(n_rows / 1.6)
    age = np.round(rng.normal(-2.5, 9.6, n_sub) * 16) / 16
    year = np.round(rng.uniform(0.0, 6.5, n_sub) * 16) / 16
    surgery = (rng.random(n_sub) < 0.17).astype(np.float64)
    lam1 = np.exp(HEART_BETA["age"] * age + HEART_BETA["year"] * year
                  + HEART_BETA["surgery"] * surgery) / 1500.0
    lam2 = lam1 * np.exp(HEART_BETA["transplant"])
    wait = np.where(rng.random(n_sub) < 0.65,
                    rng.exponential(300.0, n_sub), np.inf)
    t1 = rng.exponential(1.0 / lam1)
    death = np.where(t1 < wait, t1, wait + rng.exponential(1.0 / lam2))
    cens = rng.uniform(1.0, 7300.0, n_sub)
    stop = np.ceil(np.minimum(death, cens))
    event = (death <= cens).astype(np.float64)
    wd = np.ceil(wait)
    two = wd < stop
    idx = np.concatenate([np.arange(n_sub), np.flatnonzero(two)])
    return dict(
        start=np.concatenate([np.zeros(n_sub), wd[two]]),
        stop=np.concatenate([np.where(two, wd, stop), stop[two]]),
        event=np.concatenate([np.where(two, 0.0, event), event[two]]),
        age=age[idx], year=year[idx], surgery=surgery[idx],
        transplant=np.concatenate([np.zeros(n_sub), np.ones(int(two.sum()))]))


def cox_score_host(cols, x, ties, strata_col, beta):
    """The partial likelihood's score vector at β in f64 numpy, written
    apart from the port (sequential cumulative sums, a loop over tie
    groups, Efron's f = k/d terms per group), on the uncentred columns
    (the score does not depend on centring)."""
    X = np.column_stack([cols[c] for c in x]).astype(np.float64)
    X = X - X.mean(axis=0)
    grad = np.zeros(len(x))
    strata = cols[strata_col] if strata_col else np.zeros(len(X))
    for s in np.unique(strata):
        rows = np.flatnonzero(strata == s)
        rows = rows[np.argsort(-cols["stop"][rows], kind="mergesort")]
        Xs, ts, t0, ev = (X[rows], cols["stop"][rows], cols["start"][rows],
                          cols["event"][rows])
        r = np.exp(Xs @ beta)
        c0, c1 = np.cumsum(r), np.cumsum(r[:, None] * Xs, axis=0)
        sp = np.argsort(-t0, kind="mergesort")
        s_sorted = t0[sp]
        k0, k1 = np.cumsum(r[sp]), np.cumsum(r[sp, None] * Xs[sp], axis=0)
        bounds = np.flatnonzero(np.diff(ts) != 0)
        first = np.concatenate([[0], bounds + 1])
        last = np.concatenate([bounds, [len(ts) - 1]])
        for a, b in zip(first, last):
            e = a + np.flatnonzero(ev[a:b + 1])
            d = len(e)
            if d == 0:
                continue
            s0, s1 = c0[b], c1[b].copy()
            k = int(np.searchsorted(-s_sorted, -ts[a], side="right"))
            if k > 0:
                s0, s1 = s0 - k0[k - 1], s1 - k1[k - 1]
            grad += Xs[e].sum(axis=0)
            if ties == "efron" and d > 1:
                f = np.arange(d) / d
                d0 = s0 - f * r[e].sum()
                d1 = s1[None, :] - f[:, None] * (r[e, None] * Xs[e]).sum(0)
                grad -= (d1 / d0[:, None]).sum(axis=0)
            else:
                grad -= d * s1 / s0
    return grad


def concordance_host(t, ev, lp):
    """(concordant, tied, comparable) with the reference's loop
    (`h2o3_tpu/models/coxph.py:147-162`)."""
    conc = ties = comp = 0
    for i in np.flatnonzero(ev):
        later = t > t[i]
        comp += int(later.sum())
        conc += int((lp[later] < lp[i]).sum())
        ties += int((lp[later] == lp[i]).sum())
    return conc, ties, comp


def coxph_heart_path(dev, card, rows=HEART_ROWS):
    """Phase 37(a): the documented CoxPH call (`start_column="start"`,
    `stop_column="stop"`, `ties="breslow"`) on a heart-shaped frame of
    `rows` rows, then Efron stratified by surgery on the other three."""
    from h2o3_tpu_torch.estimators import H2OCoxProportionalHazardsEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import coxph

    t_phase = time.perf_counter()
    cols = make_heart_like(rows, 0)
    fr = Frame.from_dict(cols)
    n_ev = int(cols["event"].sum())
    bad, rec, models = [], dict(rows=fr.nrow, events=n_ev), {}
    for name, params, x, strat in (
            ("breslow", dict(ties="breslow"), HEART_X, None),
            ("efron_strata", dict(ties="efron", stratify_by=["surgery"]),
             ["age", "year", "transplant"], "surgery")):
        t0 = time.perf_counter()
        m = H2OCoxProportionalHazardsEstimator(
            start_column="start", stop_column="stop", device=str(dev),
            **params).train(x=x + ["start", "stop"] + (
                [strat] if strat else []), y="event",
            training_frame=fr).model
        wall = time.perf_counter() - t0
        score = cox_score_host(cols, x, params["ties"], strat, m.beta)
        coef = m.coef()
        z = {k: (coef[k] - HEART_BETA[k]) / s
             for k, s in zip(m.dinfo.coef_names, m.se_coef)}
        r = dict(wall_s=wall, fit_split=m.fit_timings,
                 newton_iterations=m.newton["iterations"],
                 newton_ms=m.newton["ms"],
                 stopped_on_step=m.newton["stopped_on_step"],
                 multi_event_tie_groups=m.newton["multi_event_groups"],
                 coef=coef, se=dict(zip(m.dinfo.coef_names,
                                        m.se_coef.tolist())),
                 z_from_generator=z, loglik=m.loglik,
                 loglik_null=m.loglik_null, concordance=m.concordance,
                 host_score=score.tolist())
        rec[name] = r
        models[name] = m
        if not (m.newton["stopped_on_step"]
                and m.newton["iterations"] < 20):
            bad.append(f"{name}: Newton ran {m.newton['iterations']} "
                       "iterations without its max|step| < 1e-8 stop")
        if np.abs(score).max() > 1e-6 * n_ev:
            bad.append(f"{name}: score {np.abs(score).max():.3e} at β")
        if not m.loglik > m.loglik_null:
            bad.append(f"{name}: loglik {m.loglik} <= null {m.loglik_null}")
        if not (m.se_coef > 0).all():
            bad.append(f"{name}: a standard error <= 0")
    ef, br = models["efron_strata"], models["breslow"]
    if any(abs(v) > HEART_SE_BAR for v in rec["efron_strata"][
            "z_from_generator"].values()):
        bad.append(f"efron: β beyond {HEART_SE_BAR} SE of the generator's")
    if ef.newton["multi_event_groups"] < 1:
        bad.append("efron: no tie group with d > 1")
    rec["breslow_gap_from_efron"] = {
        k: br.coef()[k] - v for k, v in ef.coef().items()}
    # the concordance counts on a slice, card vs the reference's formula
    sl = np.arange(CONC_CHECK_ROWS)
    X = np.column_stack([cols[c][sl] for c in HEART_X])
    lp = X @ br.beta
    t, ev = cols["stop"][sl], cols["event"][sl]
    got = tuple(int(v) for v in coxph.concordance_counts(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (t, ev, lp))))
    want = concordance_host(t, ev, lp)
    rec["concordance_slice"] = dict(card=got, host=want)
    if got != want:
        bad.append(f"concordance counts {got} != host {want}")
    PHASE37_WALLS["a"] = time.perf_counter() - t_phase
    print(f"phase 37(a) CoxPH on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 37(a): " + "; ".join(bad))
    return rec, br, fr


def make_splice_like(n: int, seed: int):
    """The shape of H2O's PSVM example data (splice: 60 positions, each
    one of four scaled values, and a binary response C1): the response
    follows a nonlinear motif of positions 28-33 (an equality of two
    positions, an interaction of two, a threshold) with 5 % of labels
    flipped."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    levels = np.array([-1.0, -1 / 3, 1 / 3, 1.0])
    X = levels[rng.integers(0, 4, (n, SPLICE_POS))]
    motif = ((X[:, 28] == X[:, 29]).astype(int)
             + (X[:, 30] * X[:, 31] > 0).astype(int)
             + (np.abs(X[:, 32] - X[:, 33]) > 1).astype(int))
    y = motif >= 2
    y ^= rng.random(n) < 0.05
    cols = {f"C{i + 2}": X[:, i] for i in range(SPLICE_POS)}
    cols["C1"] = np.where(y, "1", "-1")
    return Frame.from_dict(cols, column_types={"C1": "enum"})


def psvm_splice_path(dev, card, rows=SPLICE_ROWS):
    """Phase 37(b): the documented PSVM call (gamma 0.01, rank_ratio 0.1,
    training metrics on) on a splice-shaped frame of `rows` rows, then the
    linear kernel."""
    from h2o3_tpu_torch.estimators import H2OSupportVectorMachineEstimator

    t_phase = time.perf_counter()
    fr = make_splice_like(rows, 1)
    bad, rec, models = [], dict(rows=fr.nrow), {}
    for kernel in ("gaussian", "linear"):
        t0 = time.perf_counter()
        m = H2OSupportVectorMachineEstimator(
            kernel_type=kernel, device=str(dev), **PSVM37).train(
            y="C1", training_frame=fr).model
        wall = time.perf_counter() - t0
        models[kernel] = m
        L = m.adam["losses"]
        settle = abs(L[-1] - L[max(0, len(L) - 101)]) / abs(L[-1])
        rec[kernel] = dict(
            wall_s=wall, fit_split=m.fit_timings, adam_steps=m.adam["steps"],
            adam_bound=m.adam["bound"],
            stopped_on_rule=m.adam["stopped_on_rule"],
            adam_ms_a_step=m.adam["ms_a_step"], loss_first=L[0],
            loss_last=L[-1], loss_rel_change_last_100=settle,
            svs_count=m.svs_count, auc=float(m.training_metrics.auc),
            D=int(len(m.beta)))
        # the linear kernel's loop stops on its rule; the gaussian's runs
        # the reference's bound on this frame (as the reference's does from
        # 30,000 rows up), still descending at its last step
        if not (m.adam["stopped_on_rule"]
                or (kernel == "gaussian" and len(L) == m.adam["bound"]
                    and L[-1] < L[-101])):
            bad.append(f"{kernel}: Adam ran {m.adam['steps']} steps, the "
                       f"loss moving {settle:.2e} over its last 100")
    g = models["gaussian"]
    D = g.W.shape[1]
    rng = np.random.default_rng(1234)     # the estimator's default seed
    W = rng.normal(scale=np.sqrt(2 * PSVM37["gamma"]),
                   size=(g.W.shape[0], D)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, D).astype(np.float32)
    draws_equal = W.tobytes() == g.W.tobytes() and b.tobytes() == g.b.tobytes()
    sub = fr.take(np.arange(CHECK37_ROWS))
    X = g.dinfo.transform(sub)
    Z = g._features(X).cpu().numpy()
    Zh = np.sqrt(2.0 / D) * np.cos(X.astype(np.float64) @ W.astype(np.float64)
                                   + b.astype(np.float64))
    z_err = float(np.abs(Z - Zh).max())
    f = g.decision_function(sub)
    fh = Z.astype(np.float64) @ g.beta + g.bias
    f_err = float(np.max(np.abs(f - fh) / np.maximum(1.0, np.abs(fh))))
    margin = rec["gaussian"]["auc"] - rec["linear"]["auc"]
    rec.update(draws_equal=draws_equal, z_max_abs_err=z_err,
               z_bar=4e-6 * np.sqrt(2.0 / D), decision_rel_err=f_err,
               auc_margin=margin)
    if not draws_equal:
        bad.append("W or b differ from a host default_rng draw")
    if z_err > 4e-6 * np.sqrt(2.0 / D):
        bad.append(f"Z {z_err:.3e} from the host f64 recompute")
    if f_err > 1e-6:
        bad.append(f"decision_function {f_err:.3e} from the host's")
    if margin < PSVM_AUC_MARGIN:
        bad.append(f"gaussian AUC margin {margin:.4f} < {PSVM_AUC_MARGIN}")
    PHASE37_WALLS["b"] = time.perf_counter() - t_phase
    print(f"phase 37(b) PSVM on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 37(b): " + "; ".join(bad))
    return rec, g, sub


def rulefit_higgs_path(dev, card, rows=RF37_ROWS, holdout=RF37_HOLDOUT):
    """Phase 37(c): RuleFit at its defaults (DRF, rule length 3, 50 trees,
    rules and linear terms) with the documented `max_num_rules=100`, on
    `rows` HIGGS-shaped rows and a `holdout`, against a lasso GLM on the
    28 linear terms alone (`model_type="linear"`)."""
    from h2o3_tpu_torch.estimators import H2ORuleFitEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.ops import hist_cuda

    t_phase = time.perf_counter()
    print(f"phase 37(c) cut: RuleFit on {rows} of config 1's 11,000,000 "
          f"HIGGS rows and a {holdout}-row holdout", flush=True)
    X, y = make_higgs_like(rows + holdout, N_FEAT, seed=37)
    names = [f"f{i}" for i in range(N_FEAT)]
    fr_all = Frame.from_numpy(np.column_stack([X, y]),
                              names=names + ["label"]).asfactor("label")
    fr, fh = (fr_all.take(np.arange(rows)),
              fr_all.take(np.arange(rows, rows + holdout)))
    y_h = y[rows:]
    del fr_all
    bad = []
    b1_before, rows_before = hist_cuda.launches, hist_cuda.launches_rows
    t0 = time.perf_counter()
    m = H2ORuleFitEstimator(device=str(dev), **RF37).train(
        y="label", training_frame=fr).model
    wall = time.perf_counter() - t0
    b1 = hist_cuda.launches - b1_before
    b2 = hist_cuda.launches_rows - rows_before
    t0 = time.perf_counter()
    p_h = m.predict(fh).vec("1").numeric_np()
    predict_s = time.perf_counter() - t0
    lin = H2ORuleFitEstimator(device=str(dev), model_type="linear",
                              **RF37).train(y="label", training_frame=fr).model
    p_lin = lin.predict(fh).vec("1").numeric_np()
    # every kept rule's column and support against the host's evaluation
    Xh = np.column_stack([fr.vec(n).numeric_np() for n in m.x])
    feats = m._features(fr)
    cols_equal = sup_equal = True
    for i, r in enumerate(m.rules):
        v = r.evaluate(Xh, m._col_of)
        cols_equal &= bool(np.array_equal(
            feats.vec(f"rule_{i}").numeric_np(), v))
        sup_equal &= r.support == float(v.mean())
    glm_t = m._glm.model.fit_timings
    rec = dict(rows=rows, holdout=holdout, wall_s=wall,
               fit_split=m.fit_timings, rule_counts=m.rule_counts,
               glm_split=glm_t,
               glm_pack_share=glm_t.get("pack_s", 0.0) / max(
                   m.fit_timings["glm_s"], 1e-12),
               glm_path=m._glm.model.fitplan.get("path"),
               glm_irls_iterations=m._glm.model.fitplan.get(
                   "irls_iterations"),
               glm_ista_steps=m._glm.model.fitplan.get("ista_steps"),
               b1_launches=b1, b2_launches=b2, predict_s=predict_s,
               holdout_auc=_auc(y_h, p_h), linear_auc=_auc(y_h, p_lin),
               linear_wall_s=lin.fit_timings["total_s"],
               columns_equal=cols_equal, supports_equal=sup_equal)
    rec["auc_margin"] = rec["holdout_auc"] - rec["linear_auc"]
    if not (cols_equal and sup_equal):
        bad.append("a rule column or support differs from the host's")
    if m.rule_counts["active"] > RF37["max_num_rules"]:
        bad.append(f"{m.rule_counts['active']} active rules > 100")
    if rec["auc_margin"] < RF_AUC_MARGIN:
        bad.append(f"holdout AUC margin {rec['auc_margin']:.4f} < "
                   f"{RF_AUC_MARGIN}")
    if dev.type == "cuda" and b1 < 1:
        bad.append("B1 never launched")
    if b2:
        bad.append(f"B2 launched {b2} times")
    PHASE37_WALLS["c"] = time.perf_counter() - t_phase
    print(f"phase 37(c) RuleFit on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 37(c): " + "; ".join(bad))
    return rec, m, fh


def survival_mojo_serving(dev, card, models):
    """Phase 37(d): CoxPH and RuleFit saved and loaded, each numpy scorer
    against `predict` on CHECK37_ROWS rows (`lp` within 1e-9·max(1, |lp|)
    on the f32-exact heart columns, probabilities within 1e-5); PSVM's
    export `TypeError`; one batch of each of the three served equal to
    `predict` with no fallback."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    t_phase = time.perf_counter()
    bad, out = [], {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_surv_") as d:
        for name, col, tol in (("coxph", "lp", 1e-9), ("rulefit", "1", 1e-5)):
            model, fr = models[name]
            sub = fr.take(np.arange(CHECK37_ROWS))
            scorer = mojo.load_model(mojo.save_model(model, d, f"{name}.h2o3"))
            got = scorer.predict(sub).vec(col).numeric_np()
            want = model.predict(sub).vec(col).numeric_np()
            err = float(np.max(np.abs(got - want) / np.maximum(
                1.0, np.abs(want))))
            out[name] = dict(mojo_max_rel_err=err)
            if not err <= tol:
                bad.append(f"{name}: MOJO {err:.3e} from predict")
        try:
            mojo.save_model(models["psvm"][0], d, "psvm.h2o3")
            bad.append("psvm: exported")
        except TypeError:
            out["psvm"] = dict(export="TypeError")
    engine = ScoringEngine(ServingConfig())
    try:
        for name, (model, fr) in models.items():
            batch = fr.take(np.arange(100, 357))
            served = _frame_matrix(engine.score(f"surv_{name}", model, batch))
            want = _frame_matrix(model.predict(batch))
            diff = float(np.abs(served - want).max())
            out[name]["served_max_abs_err"] = diff
            if diff > 0:
                bad.append(f"{name}: served {diff:.3e} from predict")
        snap = engine.snapshot()
    finally:
        engine.shutdown()
    out["fallback_scores"] = snap["totals"]["fallback_scores"]
    if snap["totals"]["fallback_scores"] or snap["totals"]["errors"]:
        bad.append(f"serving {snap['totals']}")
    PHASE37_WALLS["d"] = time.perf_counter() - t_phase
    print(f"phase 37(d) on {card}: " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 37(d): " + "; ".join(bad))
    return out


def _surv_small(case, n=600, seed=0):
    """tests/test_torch_coxph_psvm.py's survival frame."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    a = rng.integers(0, 3, n)
    b = rng.integers(0, 4, n)
    eta = (X @ np.array([0.8, -0.5]) if case != "categorical"
           else 0.6 * (a == 1) - 0.4 * (a == 2) + 0.3 * b)
    t = rng.exponential(1.0 / np.exp(eta))
    c = rng.exponential(2.0, n)
    tm = np.ceil(np.minimum(t, c) * 20) / 20
    return Frame.from_dict(
        {"x1": X[:, 0], "x2": X[:, 1],
         "a": np.asarray(["p", "q", "r"], dtype=object)[a],
         "b": np.asarray(["s", "t", "u", "v"], dtype=object)[b],
         "grp": np.asarray(["g0", "g1"], dtype=object)[rng.integers(0, 2, n)],
         "time": tm, "event": (t <= c).astype(np.float64),
         "start": np.floor(rng.uniform(0, 0.6, n) * tm * 20) / 20},
        column_types={"a": "enum", "b": "enum", "grp": "enum"})


def _svm_small(n=400, seed=2, kind="ring"):
    """tests/test_torch_coxph_psvm.py's frames: a ring, or the half-plane
    x0 + x1 > 0 for the linear kernel."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    y = (np.sqrt((X[:, :2] ** 2).sum(axis=1)) > 1.1 if kind == "ring"
         else X[:, 0] + X[:, 1] > 0).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["c"] = np.asarray(["k", "l", "m"], dtype=object)[rng.integers(0, 3, n)]
    cols["y"] = np.asarray(["in", "out"], dtype=object)[y]
    return Frame.from_dict(cols, column_types={"c": "enum", "y": "enum"})


def _rf_small(n=800, seed=0):
    """tests/test_torch_rulefit.py's binary frame."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = ((X[:, 0] > 0.3) & (X[:, 1] < 0.5) | (X[:, 2] > 1.0)).astype(int)
    X[::23, 3] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.asarray(["no", "yes"], dtype=object)[y]
    return Frame.from_dict(cols, column_types={"y": "enum"})


def _rf_regression_small(n=500, seed=1):
    """tests/test_torch_rulefit.py's regression frame."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["y"] = np.where(X[:, 0] > 0, 2.0, -1.0) + 0.1 * rng.normal(size=n)
    return Frame.from_dict(cols)


def survival_small_checks(dev, card):
    """Phase 37(e): card against CPU on the CPU tests' small frames
    (tests/test_torch_coxph_psvm.py, test_torch_rulefit.py), with their
    tolerances (SMALL37_TOLS) and a 3-fold CV of each estimator (RuleFit's
    under `algorithm="GBM"`)."""
    from h2o3_tpu_torch.estimators import (
        H2OCoxProportionalHazardsEstimator, H2ORuleFitEstimator,
        H2OSupportVectorMachineEstimator)

    t_phase = time.perf_counter()
    tol = SMALL37_TOLS
    bad, out = [], {}

    def pair(cls, fr, x=None, y="y", **params):
        return [cls(device=d, **params).train(x=x, y=y,
                                              training_frame=fr).model
                for d in (str(dev), "cpu")]

    for key, case, params, x in (
            ("cox_efron", "efron", dict(ties="efron"), ["x1", "x2"]),
            ("cox_breslow_start", "efron",
             dict(ties="breslow", start_column="start"), ["x1", "x2", "start"]),
            ("cox_strata_start", "efron", dict(
                ties="efron", start_column="start", stratify_by=["grp"]),
             ["x1", "x2", "grp", "start"]),
            ("cox_categorical", "categorical", dict(ties="efron"), ["a", "b"]),
            ("cox_cv", "efron", dict(ties="efron", nfolds=3, seed=7),
             ["x1", "x2"])):
        fr = _surv_small(case)
        t_case = time.perf_counter()
        a, c = pair(H2OCoxProportionalHazardsEstimator, fr, x=x, y="event",
                    stop_column="time", **params)
        r = dict(beta_err=float(np.abs(a.beta - c.beta).max()),
                 se_rel_err=float(np.abs(a.se_coef - c.se_coef).max()
                                  / np.abs(c.se_coef).max()),
                 concordance_equal=a.concordance == c.concordance)
        ok = (r["beta_err"] <= tol["cox_beta"]
              and r["se_rel_err"] <= tol["cox_se"] and r["concordance_equal"])
        if "nfolds" in params:
            r["cv_holdout_err"] = float(np.abs(
                a._cv_holdout_pred - c._cv_holdout_pred).max())
            ok &= r["cv_holdout_err"] <= tol["cv_cox"] * max(
                1.0, float(np.abs(c._cv_holdout_pred).max()))
        r["pair_wall_s"] = time.perf_counter() - t_case
        out[key] = r
        if not ok:
            bad.append(f"{key}: {r}")
    for key, fr, params in (
            ("psvm_gaussian", _svm_small(), dict(
                kernel_type="gaussian", seed=5, gamma=1.0,
                positive_weight=2.0)),
            ("psvm_linear", _svm_small(kind="linear"), dict(
                kernel_type="linear", seed=5)),
            ("psvm_cv", _svm_small(360, 4), dict(gamma=1.0, nfolds=3,
                                                 seed=7))):
        t_case = time.perf_counter()
        a, c = pair(H2OSupportVectorMachineEstimator, fr, **params)
        fa, fc = a.decision_function(fr), c.decision_function(fr)
        r = dict(decision_err=float(np.max(np.abs(fa - fc) / np.maximum(
            1.0, np.abs(fc)))), auc_err=abs(float(a.training_metrics.auc)
                                           - float(c.training_metrics.auc)),
                 svs_gap=abs(a.svs_count - c.svs_count),
                 steps=(a.adam["steps"], c.adam["steps"]))
        ok = (r["decision_err"] <= tol["psvm_decision"]
              and r["auc_err"] <= tol["psvm_auc"]
              and r["svs_gap"] <= tol["psvm_svs"])
        if "nfolds" in params:
            r["cv_holdout_err"] = float(np.abs(
                a._cv_holdout_pred - c._cv_holdout_pred).max())
            ok &= r["cv_holdout_err"] <= tol["cv_psvm"]
        r["pair_wall_s"] = time.perf_counter() - t_case
        out[key] = r
        if not ok:
            bad.append(f"{key}: {r}")
    # RuleFit's pairs are cut (PERF.md §4): the regression to
    # RF_SMALL_TREES trees from 10, the CV to RF_SMALL_FOLDS folds of
    # RF_SMALL_CV_TREES trees on RF_SMALL_CV_ROWS rows from 3 of 8 on 600;
    # a fit's time is its lasso GLM path's IRLS iterations (hundreds on
    # this separable frame)
    print(f"phase 37(e) cut: RuleFit's regression pair {RF_SMALL_TREES} "
          f"trees (from 10), its CV pair {RF_SMALL_FOLDS} folds of "
          f"{RF_SMALL_CV_TREES} trees on {RF_SMALL_CV_ROWS} rows (from 3 of "
          "8 on 600)", flush=True)
    for key, fr, col, params in (
            ("rulefit_drf_regression", _rf_regression_small(), "predict",
             dict(model_type="rules", min_rule_length=1, max_rule_length=2,
                  rule_generation_ntrees=RF_SMALL_TREES, seed=3)),
            ("rulefit_cv", _rf_small(RF_SMALL_CV_ROWS, 3), "1",
             dict(nfolds=RF_SMALL_FOLDS,
                  rule_generation_ntrees=RF_SMALL_CV_TREES, seed=5,
                  algorithm="GBM"))):
        t_case = time.perf_counter()
        a, c = pair(H2ORuleFitEstimator, fr, **params)
        forests_equal = all(
            _forest_diff(ta, tc)[0] == 0
            for ta, tc in zip(a._tree_models, c._tree_models))
        pa, pc = (m.predict(fr).vec(col).numeric_np() for m in (a, c))
        r = dict(forests_equal=forests_equal,
                 pred_err=float(np.abs(pa - pc).max()))
        ok = r["pred_err"] <= tol["rf_pred"]
        if forests_equal:
            r["rules_equal"] = [q.conds for q in a.rules] == [
                q.conds for q in c.rules]
            r["coef_err"] = max((abs(q.coef - s.coef)
                                 for q, s in zip(a.rules, c.rules)), default=0.0)
            ok &= r["rules_equal"] and r["coef_err"] <= tol["rf_coef"]
        if "nfolds" in params:
            r["cv_holdout_err"] = float(np.abs(
                a._cv_holdout_pred - c._cv_holdout_pred).max())
            ok &= r["cv_holdout_err"] <= tol["cv_rf"]
        r["pair_wall_s"] = time.perf_counter() - t_case
        out[key] = r
        if not ok:
            bad.append(f"{key}: {r}")
    PHASE37_WALLS["e"] = time.perf_counter() - t_phase
    print(f"phase 37(e) on {card}, card vs cpu (tolerances "
          f"{json.dumps(tol)}): " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 37(e): " + "; ".join(bad))
    return out


def survival_path(dev, card):
    """Phase 37: (a)-(e) in turn with every launch count set to 0 before
    (a) and read after (e); (f) only RuleFit's trees launched a
    hand-written kernel, B1."""
    tf32_off()
    zero_counts()
    cox_rec, cox_model, cox_fr = coxph_heart_path(dev, card)
    psvm_rec, psvm_model, psvm_fr = psvm_splice_path(dev, card)
    after_ab = kernel_counts()
    rf_rec, rf_model, rf_fh = rulefit_higgs_path(dev, card)
    mojo_rec = survival_mojo_serving(dev, card, dict(
        coxph=(cox_model, cox_fr), psvm=(psvm_model, psvm_fr),
        rulefit=(rf_model, rf_fh)))
    del cox_fr, rf_fh
    small = survival_small_checks(dev, card)
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"phase 37(f): hand-written kernel launches after (a, b) "
          f"{json.dumps(after_ab)}, after (a)-(e) {json.dumps(counts)}",
          flush=True)
    if any(after_ab.values()):
        raise AssertionError(f"phase 37(f): CoxPH or PSVM launched a kernel: "
                             f"{after_ab}")
    if counts["hist"] < 1 or counts["hist_rows"] or counts["shap"]:
        raise AssertionError(f"phase 37(f): expected B1 alone: {counts}")
    return dict(coxph=cox_rec, psvm=psvm_rec, rulefit=rf_rec, mojo=mojo_rec,
                small=small, kernel_counts=counts)


# phase 38: the rest of the estimators of queue A item 10 at full width.
# (a) TargetEncoder on an Airlines-shaped frame (phase 36's generator) with
# the parameters of H2O's target-encoding user-guide example, then phase
# 4's GBM on its encodings against the same GBM on the raw enums; (b)
# Word2Vec on a text8-shaped stream; (c) Aggregator on phase 14's
# Covertype-shaped frame cut to the reference's envelope; (d) the quantiles
# op on phase 4's HIGGS column and a weighted one with NaNs; (e) XGBoost's
# lossguide growth on config 1's HIGGS frame; (f) MOJO round trips; (g)
# card against CPU on the CPU tests' small frames; (h) the launch counts
TE_ROWS, TE_HOLDOUT = 1_000_000, 200_000
TE_COLS = ["Origin", "Dest"]
TE38 = dict(data_leakage_handling="KFold", fold_column="fold", blending=True,
            inflection_point=3, smoothing=10, noise=0.15, seed=1234)
TE_GBM = dict(ntrees=NTREES, max_depth=DEPTH, learn_rate=0.1,
              histogram_type="UniformAdaptive", seed=42)
# (a)'s bar, in holdout AUC: the GBM on the encodings within TE_RAW_TOL
# below the GBM on the raw enums (a CPU rehearsal, tools/
# phase38_rehearsal.py: 0.0014 below; PERF.md §6). The GBM on DepTime and
# Distance alone is printed beside them: with the example's noise of 0.15
# on a binary response the encodings add little over it
TE_RAW_TOL = 0.005
# text8: 17,005,207 tokens of Wikipedia text, 253,854 types; cut to
# W2V_TOKENS for the phase's time
TEXT8_TOKENS, W2V_TOKENS, W2V_TYPES = 17_005_207, 1_000_000, 30_000
W2V_GROUPS, W2V_GROUP_WORDS = 10, 4
# the defaults but init_learning_rate: the reference's SGNS step takes the
# mean over a batch of B = 8192 pairs, so the default 0.025 moves a word by
# 0.025/8192 of its per-pair gradient: a CPU rehearsal (tools/
# phase38_rehearsal.py) put no planted word's top synonym in its group at
# 0.025 and all 40 at 1.0, the rate of the reference's own Word2Vec test
# (ROADMAP §C)
W2V38 = dict(vec_size=100, window_size=5, negative_samples=5, epochs=5,
             min_word_freq=5, seed=38, init_learning_rate=1.0)
# (b)'s device time a step: the fit's steps from W2V_KEPT_FROM (of its
# 4,005), W2V_KEPT of them, replayed under the profiler
W2V_KEPT_FROM, W2V_KEPT = 2_000, 10
AGG_ROWS, AGG_CHECK_ROWS = 20_000, 10_000
AGG38 = dict(target_num_exemplars=5000, rel_tol_num_exemplars=0.5,
             transform="NORMALIZE")
Q_PROBS = (0.001, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)
LG38 = dict(XGB_1, grow_policy="lossguide", max_leaves=31, max_depth=6)
LG_AUC_TOL = 0.005
SMALL38_TOLS = dict(te=0.0, w2v=1e-5, lg_value=1e-5, lg_pred=1e-5)
PHASE38_WALLS: dict = {}


def make_text8_like(n_tokens: int, seed: int):
    """A stream of `n_tokens` words shaped like text8 (Wikipedia text, a
    Zipf law of word frequencies): sentences of 8-24 words with an NA
    after each; background words `w<rank>` drawn from a Zipf law (s =
    1.05) over W2V_TYPES ranks; half the sentences carry a topic, one of
    W2V_GROUPS planted groups of W2V_GROUP_WORDS words `t<g>_<k>`, each of
    their words that group's with probability 0.4. Returns (object array
    of words with None breaks, the groups)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, W2V_TYPES + 1) ** 1.05
    p /= p.sum()
    groups = [[f"t{g}_{k}" for k in range(W2V_GROUP_WORDS)]
              for g in range(W2V_GROUPS)]
    lens = rng.integers(8, 25, n_tokens // 8)
    lens = lens[:np.searchsorted(np.cumsum(lens + 1), n_tokens)]
    n_words = int(lens.sum())
    back = np.char.add("w", rng.choice(W2V_TYPES, n_words, p=p).astype(str))
    words = back.astype(object)
    sent = np.repeat(np.arange(len(lens)), lens)
    topic = np.where(rng.random(len(lens)) < 0.5,
                     rng.integers(0, W2V_GROUPS, len(lens)), -1)[sent]
    pick = (topic >= 0) & (rng.random(n_words) < 0.4)
    flat = np.asarray([w for g in groups for w in g], dtype=object)
    words[pick] = flat[topic[pick] * W2V_GROUP_WORDS
                       + rng.integers(0, W2V_GROUP_WORDS, int(pick.sum()))]
    out = np.empty(n_words + len(lens), dtype=object)
    ends = np.cumsum(lens + 1) - 1                 # the NA after each
    mask = np.ones(len(out), bool)
    mask[ends] = False
    out[mask] = words
    out[~mask] = None
    return out, groups


def step_profile(fn, reps: int = 10):
    """(kernels launched, device ms) per call of fn(), from torch.profiler's
    CUDA activity over `reps` calls back to back, after a one-step warm-up
    of the profiler (as `kernel_device_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

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
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
    return (len(kernels) / reps,
            sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3)


def te_airlines_frames():
    """(a)'s training frame with a 5-value fold column, and its holdout."""
    fr, _, _ = make_airlines_gam_like(TE_ROWS, 38)
    fr["fold"] = np.random.default_rng(381).integers(0, 5, TE_ROWS).astype(
        np.float64)
    fh, _, yh = make_airlines_gam_like(TE_HOLDOUT, 39)
    return fr, fh, yh


def te_airlines_path(dev, card):
    """Phase 38(a): TargetEncoder fit and transforms with the card's tables
    against a host `np.add.at`, then phase 4's GBM on the encodings and on
    the raw enums. Returns (record, the encoder model, the holdout frame)."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2OTargetEncoderEstimator)

    t_phase = time.perf_counter()
    fr, fh, yh = te_airlines_frames()
    bad, rec = [], dict(rows=TE_ROWS, holdout=TE_HOLDOUT, params=TE38)
    zero_counts()
    t0 = time.perf_counter()
    te = H2OTargetEncoderEstimator(device=str(dev), columns=TE_COLS, **TE38)
    te.train(x=TE_COLS, y="IsDepDelayed", training_frame=fr)
    rec["fit_s"] = time.perf_counter() - t0
    m = te.model
    rec["fit_split"] = m.fit_timings
    t0 = time.perf_counter()
    tr = m.transform(fr, as_training=True)
    rec["transform_train_s"] = time.perf_counter() - t0
    rec["transform_train_split"] = m.transform_timings
    t0 = time.perf_counter()
    th = m.transform(fh)
    rec["transform_holdout_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    rec["encoder_launches"] = kernel_counts()
    if any(rec["encoder_launches"].values()):
        bad.append(f"the encoder launched {rec['encoder_launches']}")
    # the card's tables against a host np.add.at (a binary response: every
    # sum an integer, exact in f64 in any order)
    yv = np.asarray(fr.vec("IsDepDelayed").data, np.float64)
    fold = fr.vec("fold").numeric_np().astype(np.int64)
    exact = True
    for col in TE_COLS:
        codes = np.asarray(fr.vec(col).data)
        dom, sums, cnts, folds = m.encodings[col]
        ok = codes >= 0
        hs, hc = np.zeros(len(sums)), np.zeros(len(sums))
        np.add.at(hs, codes[ok], yv[ok])
        np.add.at(hc, codes[ok], 1.0)
        exact &= np.array_equal(hs, sums) and np.array_equal(hc, cnts)
        for fid, (fs, fc) in folds.items():
            mk = ok & (fold == fid)
            gs, gc = hs.copy(), hc.copy()
            np.add.at(gs, codes[mk], -yv[mk])
            np.add.at(gc, codes[mk], -1.0)
            exact &= np.array_equal(gs, fs) and np.array_equal(gc, fc)
    rec["tables_equal_host"] = bool(exact)
    if not exact:
        bad.append("the card's level tables differ from np.add.at's")
    te_cols = [f"{c}_te" for c in TE_COLS]
    for c in te_cols:
        for f in (tr, th):
            v = np.asarray(f.vec(c).data)
            if v.dtype != np.float32 or not np.isfinite(v).all():
                bad.append(f"{c}: {v.dtype}, finite {np.isfinite(v).all()}")
    aucs = {}
    for tag, frame, hold, x in (
            ("raw", fr, fh, ["DepTime", "Distance"] + TE_COLS),
            ("te", tr, th, ["DepTime", "Distance"] + te_cols),
            ("numeric", fr, fh, ["DepTime", "Distance"])):
        zero_counts()
        t0 = time.perf_counter()
        g = H2OGradientBoostingEstimator(device=str(dev), **TE_GBM)
        g.train(x=x, y="IsDepDelayed", training_frame=frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_counts = kernel_counts()
        zero_counts()
        p1 = g.predict(hold).vec("YES").numeric_np()
        torch.cuda.synchronize()
        aucs[tag] = _auc(yh, p1)
        rec[f"gbm_{tag}"] = dict(wall_s=wall, holdout_auc=aucs[tag],
                                 fit_launches=fit_counts,
                                 predict_launches=kernel_counts())
        if (fit_counts["hist"] != NTREES * DEPTH or fit_counts["hist_rows"]
                or fit_counts["score"] or fit_counts["shap"]):
            bad.append(f"gbm {tag}: fit launches {fit_counts}; expected "
                       f"{NTREES * DEPTH} B1 and nothing else")
    rec["auc_te_minus_raw"] = aucs["te"] - aucs["raw"]
    rec["auc_te_minus_numeric"] = aucs["te"] - aucs["numeric"]
    if not rec["auc_te_minus_raw"] >= -TE_RAW_TOL:
        bad.append(f"the GBM on the encodings {aucs['te']:.6f} lies more "
                   f"than {TE_RAW_TOL} below the raw enums' {aucs['raw']:.6f}")
    PHASE38_WALLS["a"] = time.perf_counter() - t_phase
    print(f"phase 38(a) TargetEncoder on {card}: " + json.dumps(rec),
          flush=True)
    if bad:
        raise AssertionError("phase 38(a): " + "; ".join(bad))
    return rec, m, fh


def w2v_text8_path(dev, card):
    """Phase 38(b): Word2Vec at W2V38 on W2V_TOKENS text8-shaped tokens;
    the fit's split, its ms a step, and the launches, device ms and busy
    share a step from the fit's own steps W2V_KEPT_FROM onwards (their
    indices, weights and rates kept during the fit) replayed under the
    profiler. Returns (record, model, a slice of the stream)."""
    import itertools

    from h2o3_tpu_torch.estimators import H2OWord2vecEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models import word2vec

    t_phase = time.perf_counter()
    words, groups = make_text8_like(W2V_TOKENS, 38)
    fr = Frame({"words": Vec(None, "string", strings=words)})
    params = W2V38
    n_breaks = sum(w is None for w in words)
    print(f"phase 38(b) corpus (text8's shape): {len(words) - n_breaks} "
          f"tokens and {n_breaks} NA breaks; cut: {W2V_TOKENS} tokens of "
          f"text8's {TEXT8_TOKENS}; params {params}", flush=True)
    bad = []
    step, kept = word2vec.sgns_step, []

    def keeping_step(*args):
        """The fit's step; the inputs of W2V_KEPT steps are kept (the step
        does not change them: it returns new weights)."""
        if W2V_KEPT_FROM <= keeping_step.calls < W2V_KEPT_FROM + W2V_KEPT:
            kept.append(args)
        keeping_step.calls += 1
        return step(*args)

    keeping_step.calls = 0
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(word2vec, "sgns_step", keeping_step):
        est = H2OWord2vecEstimator(device=str(dev), **params)
        est.train(training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    m = est.model
    st, ft = m.fit_stats, m.fit_timings
    rec = dict(wall_s=wall, fit_split=ft, **st,
               ms_per_step=ft["loop_s"] / st["steps"] * 1e3,
               fit_launches=counts)
    # the fit's own steps replayed under the profiler: the corpus's Zipf
    # law sets how often `index_add_` hits one row
    cycle = itertools.cycle(kept)
    launches, dev_ms = step_profile(lambda: step(*next(cycle)),
                                    reps=W2V_KEPT)
    del kept, cycle
    rec["profiled_steps"] = [W2V_KEPT_FROM, W2V_KEPT_FROM + W2V_KEPT]
    rec["launches_per_step"] = launches
    rec["device_ms_per_step"] = dev_ms
    rec["busy_share"] = dev_ms / rec["ms_per_step"]
    syn = {}
    for grp in groups:
        for w in grp:
            top = list(m.find_synonyms(w, 1))
            syn[w] = top[0] if top else None
            if not top or top[0] not in grp:
                bad.append(f"{w}'s top synonym {top} lies outside its group")
    rec["top_synonyms"] = syn
    head = words[:5000]
    fh = Frame({"words": Vec(None, "string", strings=head)})
    avg = m.transform(fh, aggregate_method="AVERAGE")
    n_sent = int(sum(w is None for w in head)) + 1
    rec["average_rows"] = [avg.nrow, n_sent]
    if avg.nrow != n_sent or avg.ncol != W2V38["vec_size"]:
        bad.append(f"AVERAGE: {avg.nrow} x {avg.ncol}, expected {n_sent} "
                   f"sentences x {W2V38['vec_size']}")
    if any(counts.values()):
        bad.append(f"Word2Vec launched a hand-written kernel: {counts}")
    PHASE38_WALLS["b"] = time.perf_counter() - t_phase
    print(f"phase 38(b) Word2Vec on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 38(b): " + "; ".join(bad[:8]))
    return rec, m, fh


def agg_covtype_path(dev, card):
    """Phase 38(c): Aggregator at its defaults on phase 14's Covertype
    frame cut to AGG_ROWS rows. Returns (record, model)."""
    from h2o3_tpu_torch.estimators import H2OAggregatorEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    t_phase = time.perf_counter()
    X, _ = make_covtype_like(COV_ROWS, 5)
    fr = Frame.from_numpy(X[:AGG_ROWS], names=COV_NAMES)
    del X
    bad = []
    zero_counts()
    t0 = time.perf_counter()
    est = H2OAggregatorEstimator(device=str(dev), **AGG38)
    est.train(x=COV_NAMES, training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    m = est.model
    idx, cnt = np.asarray(m.exemplar_idx), np.asarray(m.counts)
    r2 = m.passes[-1]["radius2"]
    rec = dict(rows=AGG_ROWS, cols=len(COV_NAMES), wall_s=wall,
               fit_split=m.fit_timings, passes=m.passes,
               exemplars=len(idx), fit_launches=counts)
    if cnt.sum() != AGG_ROWS:
        bad.append(f"counts sum to {cnt.sum()}, not {AGG_ROWS}")
    t, tol = AGG38["target_num_exemplars"], AGG38["rel_tol_num_exemplars"]
    if not t * (1 - tol) <= len(idx) <= t * (1 + tol):
        bad.append(f"{len(idx)} exemplars outside {t} ± {tol * 100:.0f} %")
    # a sample of non-exemplar rows, each within the final radius of an
    # exemplar, in f64 (slack: the f32 expansion's rounding of d2)
    A = m.dinfo.transform(fr).astype(np.float64)
    E = A[idx]
    rest = np.setdiff1d(np.arange(AGG_ROWS), idx)
    pick = np.random.default_rng(383).choice(rest, AGG_CHECK_ROWS,
                                             replace=False)
    S = A[pick]
    d2 = ((S * S).sum(1)[:, None] - 2 * S @ E.T
          + (E * E).sum(1)[None, :]).min(1)
    slack = 1e-5 * ((S * S).sum(1) + (E * E).sum(1).max())
    rec["radius2"] = r2
    rec["sample_max_d2_over_r2"] = float((d2 / r2).max())
    if not (d2 <= r2 + slack).all():
        bad.append(f"{int((d2 > r2 + slack).sum())} sampled rows lie beyond "
                   f"the radius (max d2/r2 {rec['sample_max_d2_over_r2']})")
    if any(counts.values()):
        bad.append(f"Aggregator launched a hand-written kernel: {counts}")
    try:
        m.predict(fr)
        bad.append("predict did not raise")
    except ValueError:
        pass
    PHASE38_WALLS["c"] = time.perf_counter() - t_phase
    print(f"phase 38(c) Aggregator on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 38(c): " + "; ".join(bad))
    return rec, m


def _quantiles_f64(x, w, probs):
    """The weighted inverse CDF in f64: for each p the smallest value whose
    cumulative weight reaches the op's target, f32(p)·f32(W) rounded to f32
    as the op computes it (NaN and zero-weight rows dropped)."""
    ok = ~np.isnan(x) & (w > 0)
    xs, ws = x[ok].astype(np.float64), w[ok].astype(np.float64)
    o = np.argsort(xs, kind="stable")
    xs, cw = xs[o], np.cumsum(ws[o])
    W = np.float32(cw[-1])
    return np.asarray([xs[min(np.searchsorted(cw, float(np.float32(p) * W)),
                              len(xs) - 1)] for p in probs])


def quantiles_path(dev, card):
    """Phase 38(d): the quantiles op on phase 4's first HIGGS column (unit
    weights: the card equal to the CPU bit for bit) and on a weighted
    column with NaNs; each within one final-refinement bin plus f32
    spacing of the weighted f64 inverse CDF."""
    from h2o3_tpu_torch.ops.quantiles import distributed_quantiles

    t_phase = time.perf_counter()
    X, _ = make_higgs_like(N_ROWS)
    rng = np.random.default_rng(384)
    x1 = X[:, 0].copy()
    x2 = X[:, 1].copy()
    x2[rng.random(N_ROWS) < 0.05] = np.nan
    w2 = rng.uniform(0, 2, N_ROWS).astype(np.float32)
    w2[rng.random(N_ROWS) < 0.05] = 0
    del X
    bad, rec = [], {}
    zero_counts()
    for tag, x, w in (("unit", x1, np.ones(N_ROWS, np.float32)),
                      ("weighted_nan", x2, w2)):
        xd, wd = (torch.from_numpy(a).to(dev) for a in (x, w))
        got = distributed_quantiles(xd, wd, Q_PROBS).cpu().numpy()
        ms = time_ms(lambda: distributed_quantiles(xd, wd, Q_PROBS), reps=3,
                     warmup=1)
        cpu = distributed_quantiles(torch.from_numpy(x), torch.from_numpy(w),
                                    Q_PROBS).numpy()
        ok = ~np.isnan(x) & (w > 0)
        step = float(x[ok].max() - x[ok].min()) / 1024.0 ** 3
        exact = _quantiles_f64(x, w, Q_PROBS)
        tol = step + np.spacing(np.abs(exact).astype(np.float32))
        err = np.abs(got.astype(np.float64) - exact)
        r = dict(ms=ms, quantiles=got.tolist(),
                 max_err_over_tol=float((err / tol).max()),
                 equal_to_cpu=bool(np.array_equal(got, cpu)))
        rec[tag] = r
        if not (err <= tol).all():
            bad.append(f"{tag}: {r['max_err_over_tol']:.3f} bins from f64")
        if tag == "unit" and not r["equal_to_cpu"]:
            bad.append("unit weights: the card differs from the CPU")
        del xd, wd
    torch.cuda.synchronize()
    rec["launches"] = kernel_counts()
    if any(rec["launches"].values()):
        bad.append(f"the quantiles op launched {rec['launches']}")
    PHASE38_WALLS["d"] = time.perf_counter() - t_phase
    print(f"phase 38(d) quantiles on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 38(d): " + "; ".join(bad))
    return rec


class b1_recorder:
    """Keeps the inputs of the first `n` B1 launches (`hist_build`) while
    it is entered: one lossguide tree's passes. The wrapper only records;
    the kernel's own wrapper counts the launch."""

    def __init__(self, n):
        self.n, self.calls = n, []

    def __enter__(self):
        from h2o3_tpu_torch.ops import hist_cuda

        self.orig = hist_cuda.hist_build

        def spy(codes, node, vals, L, nbins):
            if len(self.calls) < self.n:
                self.calls.append((node.clone(), vals.clone(), L, nbins))
            return self.orig(codes, node, vals, L, nbins)

        hist_cuda.hist_build = spy
        return self

    def __exit__(self, *exc):
        from h2o3_tpu_torch.ops import hist_cuda

        hist_cuda.hist_build = self.orig
        return False


def lossguide_path(dev, fr, card, xgb1_auc: float):
    """Phase 38(e): XGBoost with `grow_policy="lossguide"`, `max_leaves=31`
    on phase 4's frame, its holdout AUC against phase 31(b)'s XGBoost_1's
    (`xgb1_auc`); B1 at tree 0's passes as they ran (each L = 1 over
    all rows, most weights zero): bit-equal to `hist_plain_fixed`, timed
    (L2 flushed) against the plain version, one `index_add_` and the
    bytes bound. Returns (record, model, the kernels line's entry)."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.tree import lossguide_slots
    from h2o3_tpu_torch.ops import histogram

    t_phase = time.perf_counter()
    bad = []
    names = [f"f{i}" for i in range(N_FEAT)]
    S = lossguide_slots(LG38["max_depth"], LG38["max_leaves"])
    est = H2OXGBoostEstimator(seed=42, device=str(dev), **LG38)
    zero_counts()
    t0 = time.perf_counter()
    with b1_recorder(S) as rec_b1:
        est.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, dispatch = kernel_counts(), dict(histogram.DISPATCH)
    m = est.model
    leaves = (m.forest[0].is_split.sum(dim=1) + 1).cpu().numpy()
    splits_total = int((leaves - 1).sum())
    Xt, yt = make_higgs_like(XGB_PREDICT_ROWS, seed=1)
    ft_ = Frame.from_numpy(np.column_stack([Xt, yt]),
                           names=names + ["label"]).asfactor("label")
    zero_counts()
    pred = m.predict(ft_)
    p1 = pred.vec("1").numeric_np()
    auc = _auc(yt, p1)
    # tree 0's passes replayed: the kernel against its plain twins
    codes = _fit_codes_fm(m, dev)
    passes = []
    for node, vals, L, nbins in rec_b1.calls:
        n_w = int((vals[0] != 0).sum())
        r = dict(L=L, weighted_rows=n_w)
        r["max_abs_err"] = check_b1(codes, node, vals, L, nbins)[0]
        r["ms"] = time_ms_cold(
            lambda: histogram.hist_cuda.hist_build(codes, node, vals, L,
                                                   nbins), reps=5, warmup=1)
        r["plain_ms"] = time_ms(
            lambda: histogram.hist_cuda.hist_plain(codes, node, vals, L,
                                                   nbins), reps=2, warmup=1)
        r["library_ms"] = bm_library_ms(dev, codes, node, vals, L, nbins)
        r["bound_ms"] = bound_ms_of(n_w, L, n_feat=N_FEAT, nbins=nbins)[0]
        passes.append(r)
    del codes, rec_b1
    tree = {k: sum(r[k] for r in passes)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rec = dict(trees=m.ntrees_built, wall_s=wall,
               trees_per_s=m.ntrees_built / wall, fit_split=m.fit_timings,
               b1_launches=counts["hist"], expected_b1=m.ntrees_built
               + splits_total, dispatch=dispatch,
               leaves_max=int(leaves.max()), leaves_mean=float(leaves.mean()),
               holdout_auc=auc, xgboost_1_holdout_auc=xgb1_auc,
               b1_tree0=dict(passes=len(passes), **tree),
               b1_fit_ms_estimate=tree["ms"] * m.ntrees_built)
    if leaves.max() > LG38["max_leaves"]:
        bad.append(f"a tree has {leaves.max()} leaves")
    if counts["hist"] != rec["expected_b1"] or set(dispatch) != {
            "pallas_factored"} or counts["hist_rows"] or counts["shap"] \
            or counts["score"]:
        bad.append(f"fit launches {counts}, dispatch {dispatch}; expected "
                   f"{rec['expected_b1']} B1 and nothing else")
    if abs(auc - xgb1_auc) > LG_AUC_TOL:
        bad.append(f"holdout AUC {auc:.6f} vs XGBoost_1's {xgb1_auc:.6f}")
    if m.hist_plan != [("lossguide_node", 1)]:
        bad.append(f"plan {m.hist_plan}")
    PHASE38_WALLS["e"] = time.perf_counter() - t_phase
    print(f"phase 38(e) lossguide on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 38(e): " + "; ".join(bad))
    entry = dict(
        name="hist_factored_lossguide", route="cuda",
        source="h2o3_tpu_torch/csrc/hist.cu",
        replaces="h2o3_tpu/ops/hist_pallas.py:103", launches=counts["hist"],
        max_abs_err=max(r["max_abs_err"] for r in passes), **tree,
        bound_by="bytes")
    return rec, m, ft_, entry


def item10_mojo(dev, card, te_model, te_hold, w2v_model, w2v_frame,
                agg_model, lg_model, lg_frame):
    """Phase 38(f): the MOJO round trips of (a), (b) and (e); Aggregator's
    export raises `TypeError`."""
    from h2o3_tpu_torch import mojo

    t_phase = time.perf_counter()
    bad, rec = [], {}
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke38_") as d:
        sc = mojo.load_model(mojo.save_model(te_model, d, "te.h2o3"))
        got, want = sc.predict(te_hold), te_model.transform(te_hold)
        rec["te_max_abs_err"] = max(float(np.abs(
            np.asarray(got.vec(c).data, np.float64)
            - np.asarray(want.vec(c).data, np.float64)).max())
            for c in ("Origin_te", "Dest_te"))
        sc = mojo.load_model(mojo.save_model(w2v_model, d, "w2v.h2o3"))
        rec["w2v_vectors_equal"] = bool(np.array_equal(
            sc.arrays["w2v_vectors"], w2v_model.vectors))
        words = [w for w in w2v_model.vocab[:50]]
        rec["w2v_synonyms_equal"] = all(
            sc.find_synonyms(w, 5) == w2v_model.find_synonyms(w, 5)
            for w in words)
        same = True
        for method in ("NONE", "AVERAGE"):
            a = sc.transform(w2v_frame, aggregate_method=method)
            b = w2v_model.transform(w2v_frame, aggregate_method=method)
            same &= all(np.array_equal(a.vec(n).numeric_np(),
                                       b.vec(n).numeric_np(), equal_nan=True)
                        for n in b.names)
        rec["w2v_transform_equal"] = bool(same)
        sc = mojo.load_model(mojo.save_model(lg_model, d, "lg.h2o3"))
        rec["lossguide_max_abs_err"] = float(np.abs(
            sc.predict(lg_frame).vec("1").numeric_np()
            - lg_model.predict(lg_frame).vec("1").numeric_np()).max())
        try:
            mojo.save_model(agg_model, d, "agg.h2o3")
            rec["aggregator_export"] = "exported"
        except TypeError:
            rec["aggregator_export"] = "TypeError"
    if rec["te_max_abs_err"] != 0.0:
        bad.append(f"TargetEncoder MOJO {rec['te_max_abs_err']:.3e} away")
    if not (rec["w2v_vectors_equal"] and rec["w2v_synonyms_equal"]
            and rec["w2v_transform_equal"]):
        bad.append("Word2Vec MOJO differs from the model")
    if not rec["lossguide_max_abs_err"] <= 1e-6:
        bad.append(f"lossguide MOJO {rec['lossguide_max_abs_err']:.3e} away")
    if rec["aggregator_export"] != "TypeError":
        bad.append("the Aggregator exported")
    PHASE38_WALLS["f"] = time.perf_counter() - t_phase
    print(f"phase 38(f) on {card}: " + json.dumps(rec), flush=True)
    if bad:
        raise AssertionError("phase 38(f): " + "; ".join(bad))
    return rec


def _te_small(n=3000, seed=0):
    """tests/test_torch_targetencoder.py's frame: two enum columns with
    NAs (one of ~150 Zipf levels), a binary response, a fold column."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, n)
    b = rng.zipf(1.6, n) % 150
    p = 1 / (1 + np.exp(-(a - 2.5) * 0.6 + (b % 7 - 3) * 0.3))
    d = {"a": np.asarray([f"a{v}" for v in a], dtype=object),
         "b": np.asarray([f"b{v}" for v in b], dtype=object),
         "fold": rng.integers(0, 5, n).astype(np.float32)}
    d["a"][rng.random(n) < 0.05] = None
    d["b"][rng.random(n) < 0.03] = None
    d["y"] = np.asarray(["no", "yes"], dtype=object)[
        (rng.random(n) < p).astype(int)]
    return Frame.from_dict(d, column_types={"a": "enum", "b": "enum",
                                            "y": "enum"})


def _blobs_small():
    """tests/test_torch_aggregator_word2vec.py's separated blobs."""
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 4.0
    offs = np.asarray([[0, 0, 0], [0.8, 0, 0], [0, 0.62, 0], [1.0, 0.9, 0.4]])
    X = np.concatenate([c + o + rng.normal(0, 0.01, size=(25, 3))
                        for c in g for o in offs])
    rng.shuffle(X)
    return X


def _w2v_small():
    """tests/test_torch_aggregator_word2vec.py's mixed corpus."""
    rng = np.random.default_rng(7)
    words = np.asarray([f"w{int(v)}" for v in rng.zipf(1.4, 1200) % 60],
                       dtype=object)
    words[rng.random(1200) < 0.06] = None
    words[0] = words[-1] = None
    return words


def _lg_small(n=6000, seed=1):
    """tests/test_torch_lossguide.py's binomial frame."""
    from h2o3_tpu_torch.frame.frame import Frame

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    noise = rng.normal(size=n)
    d = {f"f{i}": X[:, i] for i in range(8)}
    d["y"] = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * noise) > 0).astype(
        int).astype(str)
    return Frame.from_dict(d, column_types={"y": "enum"})


def item10_small_checks(dev, card):
    """Phase 38(g): card against CPU on the CPU tests' small frames."""
    from h2o3_tpu_torch.estimators import (H2OAggregatorEstimator,
                                           H2OTargetEncoderEstimator,
                                           H2OWord2vecEstimator,
                                           H2OXGBoostEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models.tree import forest_leaves
    from h2o3_tpu_torch.ops.quantiles import distributed_quantiles

    t_phase = time.perf_counter()
    bad, out = [], {}
    fr = _te_small()
    for mode, extra in (("None", {}), ("LeaveOneOut", {}),
                        ("KFold", dict(fold_column="fold"))):
        ms = [H2OTargetEncoderEstimator(
            device=d, data_leakage_handling=mode, blending=True, noise=0.15,
            seed=1234, **extra).train(x=["a", "b"], y="y",
                                      training_frame=fr).model
            for d in (str(dev), "cpu")]
        tables = all(
            all(np.array_equal(x, y) for x, y in zip(ms[0].encodings[c][1:3],
                                                     ms[1].encodings[c][1:3]))
            and all(np.array_equal(ms[0].encodings[c][3][f][i],
                                   ms[1].encodings[c][3][f][i])
                    for f in ms[1].encodings[c][3] for i in (0, 1))
            for c in ("a", "b"))
        cols = all(np.array_equal(
            np.asarray(ms[0].transform(fr, as_training=t).vec(c).data),
            np.asarray(ms[1].transform(fr, as_training=t).vec(c).data))
            for t in (True, False) for c in ("a_te", "b_te"))
        out[f"te_{mode}"] = dict(tables_equal=tables, te_equal=cols)
        if not (tables and cols):
            bad.append(f"te {mode}: {out[f'te_{mode}']}")
    words = _w2v_small()
    wf = Frame({"words": Vec(None, "string", strings=words)})
    wm = [H2OWord2vecEstimator(device=d, vec_size=16, min_word_freq=5,
                               epochs=3, window_size=4, seed=11,
                               init_learning_rate=20.0).train(
        training_frame=wf).model for d in (str(dev), "cpu")]
    err = float(np.abs(wm[0].vectors - wm[1].vectors).max())
    tops = [list(m_.find_synonyms("w3", 1)) for m_ in wm]
    out["w2v"] = dict(max_abs_err=err, top_equal=tops[0] == tops[1])
    if not (err <= SMALL38_TOLS["w2v"] and tops[0] == tops[1]):
        bad.append(f"w2v: {out['w2v']}")
    X = _blobs_small()
    af = Frame.from_numpy(X, names=["a", "b", "c"])
    am = [H2OAggregatorEstimator(device=d, target_num_exemplars=60,
                                 rel_tol_num_exemplars=0.2).train(
        x=["a", "b", "c"], training_frame=af).model for d in (str(dev), "cpu")]
    out["aggregator"] = dict(
        exemplars_equal=bool(np.array_equal(am[0].exemplar_idx,
                                            am[1].exemplar_idx)),
        counts_equal=bool(np.array_equal(am[0].counts, am[1].counts)))
    if not all(out["aggregator"].values()):
        bad.append(f"aggregator: {out['aggregator']}")
    rng = np.random.default_rng(0)
    xq = rng.lognormal(size=20_000).astype(np.float32)
    qs = [distributed_quantiles(torch.from_numpy(xq).to(d),
                                torch.ones(20_000, device=d), Q_PROBS
                                ).cpu().numpy() for d in (dev, "cpu")]
    out["quantiles_equal"] = bool(np.array_equal(qs[0], qs[1]))
    if not out["quantiles_equal"]:
        bad.append("quantiles differ")
    lf = _lg_small()
    lm = [H2OXGBoostEstimator(device=d, ntrees=6, seed=3, max_bins=64,
                              grow_policy="lossguide", max_leaves=12,
                              max_depth=5).train(
        x=[f"f{i}" for i in range(8)], y="y", training_frame=lf).model
        for d in (str(dev), "cpu")]
    fa, fc = (_cpu_forest(m_.forest[0]) for m_ in lm)
    same = {f: bool(torch.equal(getattr(fa, f), getattr(fc, f)))
            for f in ("feat", "bin", "thr", "is_split")}
    Xl = torch.from_numpy(np.column_stack(
        [lf.vec(f"f{i}").numeric_np() for i in range(8)]).astype(np.float64))
    leaves_equal = bool(torch.equal(forest_leaves(fa, Xl, 5),
                                    forest_leaves(fc, Xl, 5)))
    verr = float((fa.value - fc.value).abs().max())
    perr = float(np.abs(lm[0].predict(lf).vec("1").numeric_np()
                        - lm[1].predict(lf).vec("1").numeric_np()).max())
    out["lossguide"] = dict(fields_equal=same, leaves_equal=leaves_equal,
                            value_err=verr, pred_err=perr)
    if not (same["feat"] and same["is_split"] and leaves_equal
            and verr <= SMALL38_TOLS["lg_value"]
            and perr <= SMALL38_TOLS["lg_pred"]):
        bad.append(f"lossguide: {out['lossguide']}")
    PHASE38_WALLS["g"] = time.perf_counter() - t_phase
    print(f"phase 38(g) on {card}, card vs cpu (tolerances "
          f"{json.dumps(SMALL38_TOLS)}): " + json.dumps(out), flush=True)
    if bad:
        raise AssertionError("phase 38(g): " + "; ".join(bad))
    return out


def item10_path(dev, card, xgb1_auc: float):
    """Phase 38: (a)-(g) in turn, TF32 off, with the launch counts zeroed
    before each path and read after it; (h) the encoder, Word2Vec, the
    Aggregator and the quantiles launched no hand-written kernel, (a)'s
    GBMs and (e) B1 alone. `xgb1_auc` is phase 31(b)'s XGBoost_1 holdout
    AUC, (e)'s bar. Returns (record, the kernels line's entry)."""
    from h2o3_tpu_torch.frame.frame import Frame

    tf32_off()
    te_rec, te_model, te_hold = te_airlines_path(dev, card)
    w2v_rec, w2v_model, w2v_frame = w2v_text8_path(dev, card)
    agg_rec, agg_model = agg_covtype_path(dev, card)
    q_rec = quantiles_path(dev, card)
    X, y = make_higgs_like(N_ROWS)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=[
        f"f{i}" for i in range(N_FEAT)] + ["label"]).asfactor("label")
    del X
    lg_rec, lg_model, lg_frame, entry = lossguide_path(dev, fr, card,
                                                       xgb1_auc)
    del fr
    mojo_rec = item10_mojo(dev, card, te_model, te_hold, w2v_model,
                           w2v_frame, agg_model, lg_model, lg_frame)
    small = item10_small_checks(dev, card)
    h = dict(encoder=te_rec["encoder_launches"],
             gbm_fits={k: te_rec[f"gbm_{k}"]["fit_launches"]
                       for k in ("raw", "te", "numeric")},
             word2vec=w2v_rec["fit_launches"],
             aggregator=agg_rec["fit_launches"], quantiles=q_rec["launches"],
             lossguide=dict(hist=lg_rec["b1_launches"]))
    print(f"phase 38(h) launch counts on {card}: " + json.dumps(h),
          flush=True)
    return dict(te=te_rec, w2v=w2v_rec, agg=agg_rec, quantiles=q_rec,
                lossguide=lg_rec, mojo=mojo_rec, small=small,
                launches=h), entry


# phase 39: the dataset cache and the out-of-core tree path (the block
# store with its disk tier, the streamed GBM/DRF step and GOSS). (a)-(c)
# run on config 1's HIGGS shape (`make_higgs_like`, the generator
# tools/automl_higgs.py uses) at OOC_ROWS of its 11,000,000 rows, the cut
# printed on the phase's line: the host's frame build and binning take
# ≈2.5 s a million rows and GOSS's per-tree host sample ≈0.4 s a million
# (18 trees a fit, two fits), and at 2,000,000 rows the phase took 73.6 s
# on a fast host and 98.8 s on a slow one (H100, 700 W), past its 90 s.
# The stream budget is a quarter of the packed codes: the store holds
# four of its blocks and streams the rest every level.
OOC_ROWS_FROM, OOC_ROWS, OOC_HOLDOUT = 11_000_000, 1_000_000, 100_000
OOC_GBM = dict(ntrees=20, max_depth=6, learn_rate=0.1, nbins=20,
               histogram_type="UniformAdaptive", seed=42)
OOC_GOSS = dict(goss=True, goss_top_rate=0.2, goss_other_rate=0.1)
OOC_GOSS_AUC_TOL = 0.01
# (d)-(f): 1,000,000 of (a)'s rows; (d) 5 trees through the disk tier,
# (e) a 5-tree depth-12 DRF on B2, (f) three candidates of a random grid
OOC_SMALL, OOC_DISK_TREES = 1_000_000, 5
OOC_DRF = dict(ntrees=5, max_depth=12, hist_method="pallas",
               sample_rate=0.632, seed=42)
OOC_GRID = dict(learn_rate=[0.05, 0.1, 0.2], max_depth=[4, 5, 6],
                sample_rate=[0.7, 1.0])
OOC_GRID_MODELS = 3
# (g): card against CPU on phase 5's fixture, S = 4
OOC_SMALL_S = 4
OOC_LEVELS = [1, 1, 2, 4, 8, 16]    # B1's passes of one depth-6 tree
PHASE39_WALLS: dict = {}
_OOC_KNOBS = ("H2O3_TREE_OOC", "H2O3_STREAM_BLOCKS", "H2O3_STREAM_BUDGET_MB",
              "H2O3_STREAM_HOST_BUDGET_MB", "H2O3_TREE_OOC_DISK",
              "H2O3_SPILL_DIR", "H2O3_TREE_SHARD", "H2O3_TREE_SHARD_BLOCKS",
              "H2O3_DATASET_CACHE")


def ooc_env(**knobs):
    """The out-of-core and cache knobs as given (the others unset) while
    the context is entered."""
    env = {k: v for k, v in os.environ.items() if k not in _OOC_KNOBS}
    env.update({k: str(v) for k, v in knobs.items()})
    return mock.patch.dict(os.environ, env, clear=True)


def _ooc_fit(dev, fr, params, algo="gbm", **knobs):
    """(model, wall s, device peak bytes, B1 launches, B2 launches) of one
    fit under `knobs`, the launch counts zeroed just before it."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.ops import hist_cuda

    cls = (H2OGradientBoostingEstimator if algo == "gbm"
           else H2ORandomForestEstimator)
    with ooc_env(**knobs):
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        est = cls(device=str(dev), **params)
        est.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (est.model, wall, torch.cuda.max_memory_allocated(dev),
            hist_cuda.launches, hist_cuda.launches_rows)


def _bitexact(a, b, fr) -> list:
    """What differs between two models: forest, varimp, scoring history,
    tree count, `predict` on `fr` (empty when they agree bit for bit)."""
    out = []
    if a.ntrees_built != b.ntrees_built:
        out.append(f"trees {a.ntrees_built} vs {b.ntrees_built}")
    for k, (fa, fb) in enumerate(zip(a.forest, b.forest)):
        for f in fa._fields:
            if not torch.equal(getattr(fa, f), getattr(fb, f)):
                out.append(f"class {k} {f}")
    if a.varimp_table != b.varimp_table:
        out.append("varimp")
    keys = ("number_of_trees", "logloss", "training_deviance")
    if [[e.get(k) for k in keys] for e in a.scoring_history] != \
            [[e.get(k) for k in keys] for e in b.scoring_history]:
        out.append("scoring history")
    pa = np.asarray(a.predict(fr).vec("1").data)
    pb = np.asarray(b.predict(fr).vec("1").data)
    if not np.array_equal(pa, pb):
        out.append(f"predict (max diff {float(np.abs(pa - pb).max()):.3e})")
    return out


def _codes_mb(n: int, bits: int = 5) -> float:
    """Packed code bytes of n rows x N_FEAT at `bits`, in MB (1e6)."""
    return -(-n // 8) * 8 * N_FEAT * bits / 8 / 1e6


def ooc_higgs_path(dev, card, fr, fv, y_v):
    """Phase 39(a)-(c): the streamed GBM, the blocks lane at its S, GOSS
    twice. Returns (record, the streamed model, its store's first block
    feature-major on the card for the B1 timings)."""
    from h2o3_tpu_torch.models import dataset_cache as dsc

    bad, rec = [], dict(card=card, rows=fr.nrow, rows_from=OOC_ROWS_FROM)
    budget = _codes_mb(fr.nrow) / 4
    print(f"phase 39 cut: (a)-(c) fit {fr.nrow} of config 1's "
          f"{OOC_ROWS_FROM} HIGGS rows (the host's frame build, binning and "
          f"GOSS sampling at more rows pass the phase's 90 s); packed codes "
          f"{_codes_mb(fr.nrow):.2f} MB, stream budget {budget:.4f} MB "
          "(a quarter)", flush=True)
    t0 = time.perf_counter()
    a, wall_a, peak_a, b1_a, b2_a = _ooc_fit(
        dev, fr, OOC_GBM, H2O3_TREE_OOC=1, H2O3_STREAM_BUDGET_MB=budget)
    PHASE39_WALLS["a_s"] = time.perf_counter() - t0
    st = a._stream_stats
    S = st["blocks"]
    auc_a = _auc(y_v, np.asarray(a.predict(fv).vec("1").data))
    rec["a"] = dict(wall_s=wall_a, fit_timings=a.fit_timings, S=S,
                    stream=st, device_peak_bytes=peak_a, b1_launches=b1_a,
                    b2_launches=b2_a, block_reads=a.ntrees_built
                    * (OOC_GBM["max_depth"] + 1) * S, holdout_auc=auc_a)
    print(f"phase 39(a) streamed GBM on {card}: {json.dumps(rec['a'])}",
          flush=True)
    if S < 8 or b1_a != a.ntrees_built * OOC_GBM["max_depth"] * S or b2_a:
        bad.append(f"(a): S = {S}, B1 {b1_a}, B2 {b2_a}; expected S >= 8 "
                   f"and {a.ntrees_built} x {OOC_GBM['max_depth']} x S B1 "
                   "launches alone")
    if st["resident_block_peak"] > max(budget * 1e6, 2 * st["streamed_bytes"]
                                       // max(st["blocks_uploaded"], 1)):
        bad.append(f"(a): resident peak {st['resident_block_peak']} over the "
                   f"budget {budget} MB")
    if auc_a < 0.75:
        bad.append(f"(a): holdout AUC {auc_a:.6f} below 0.75")
    c0 = dsc.snapshot()
    t0 = time.perf_counter()
    b, wall_b, peak_b, b1_b, _ = _ooc_fit(
        dev, fr, OOC_GBM, H2O3_TREE_OOC=0, H2O3_TREE_SHARD=1,
        H2O3_TREE_SHARD_BLOCKS=S)
    PHASE39_WALLS["b_s"] = time.perf_counter() - t0
    c1 = dsc.snapshot()
    hits = {k: c1[k] - c0[k] for k in ("matrix_hits", "matrix_misses",
                                       "bins_hits", "bins_misses",
                                       "device_hits", "device_misses")}
    diff = _bitexact(a, b, fv)
    rec["b"] = dict(wall_s=wall_b, fit_timings=b.fit_timings,
                    device_peak_bytes=peak_b, b1_launches=b1_b, cache=hits,
                    differs=diff,
                    peak_saving_bytes=peak_b - peak_a,
                    codes_less_budget_bytes=int((_codes_mb(fr.nrow) - budget)
                                                * 1e6))
    print(f"phase 39(b) blocks lane at S = {S} on {card}: "
          f"{json.dumps(rec['b'])}", flush=True)
    if diff:
        bad.append(f"(b): the blocks lane differs from the streamed fit in "
                   f"{diff}")
    if hits["matrix_hits"] != 1 or hits["bins_hits"] != 1 \
            or hits["bins_misses"]:
        bad.append(f"(b): cache {hits}; expected a matrix and a bins hit")
    if not peak_a < peak_b:
        bad.append(f"(b): the streamed fit's device peak {peak_a} is not "
                   f"below the in-core fit's {peak_b}")
    t0 = time.perf_counter()
    goss = [_ooc_fit(dev, fr, dict(OOC_GBM, **OOC_GOSS), H2O3_TREE_OOC=1,
                     H2O3_STREAM_BUDGET_MB=budget) for _ in range(2)]
    PHASE39_WALLS["c_s"] = time.perf_counter() - t0
    g = goss[0][0]
    auc_g = _auc(y_v, np.asarray(g.predict(fv).vec("1").data))
    rep = _bitexact(g, goss[1][0], fv)
    rec["c"] = dict(walls_s=[x[1] for x in goss], stream=g._stream_stats,
                    b1_launches=goss[0][3], holdout_auc=auc_g,
                    auc_diff=auc_a - auc_g, repeat_differs=rep)
    print(f"phase 39(c) GOSS on {card}: {json.dumps(rec['c'])}", flush=True)
    if rep:
        bad.append(f"(c): two GOSS fits differ in {rep}")
    if not g._stream_stats["streamed_bytes"] < st["streamed_bytes"]:
        bad.append(f"(c): GOSS streamed {g._stream_stats['streamed_bytes']} "
                   f"bytes, not fewer than (a)'s {st['streamed_bytes']}")
    if abs(auc_a - auc_g) > OOC_GOSS_AUC_TOL:
        bad.append(f"(c): GOSS holdout AUC {auc_g:.6f} more than "
                   f"{OOC_GOSS_AUC_TOL} from (a)'s {auc_a:.6f}")
    # the streamed fit's first block, widened as its passes read it
    from h2o3_tpu_torch.ops.histogram import feature_major

    (store,) = [s for e in dsc._ENTRIES.values() for s in e.blocks.values()
                if s.n_blocks == S]
    block = feature_major(store.get(0), store.pack_bits)
    if bad:
        raise AssertionError("phase 39(a-c): " + "; ".join(bad))
    return rec, block


def ooc_disk_path(dev, card, fr):
    """Phase 39(d): 5 trees through the disk tier, the blocks lane at its S,
    and the spill directory and the ledger after `close()`."""
    from h2o3_tpu_torch.models import dataset_cache as dsc
    from h2o3_tpu_torch.runtime import memory_ledger as ml

    params = dict(OOC_GBM, ntrees=OOC_DISK_TREES)
    # a third of the codes on the host, a quarter on the card: every level
    # reads most blocks back from disk (the page cache is warm)
    host_mb, budget = _codes_mb(fr.nrow) / 3, _codes_mb(fr.nrow) / 4
    bad = []
    with tempfile.TemporaryDirectory(prefix="h2o3_smoke_spill_") as root:
        t0 = time.perf_counter()
        a, wall, _, b1, _ = _ooc_fit(dev, fr, params, H2O3_TREE_OOC=1,
                                     H2O3_STREAM_BUDGET_MB=budget,
                                     H2O3_STREAM_HOST_BUDGET_MB=host_mb,
                                     H2O3_SPILL_DIR=root)
        st = a._stream_stats
        b, _, _, _, _ = _ooc_fit(dev, fr, params, H2O3_TREE_OOC=0,
                                 H2O3_TREE_SHARD=1,
                                 H2O3_TREE_SHARD_BLOCKS=st["blocks"])
        diff = _bitexact(a, b, fr)
        files_before = sum(len(fs) for _, _, fs in os.walk(root))
        dsc.clear()                   # closes the cached store
        files_after = sorted(os.listdir(root))
        leaks = [lk for lk in ml.refresh(force=True)["leaks"]
                 if lk["kind"] in ("block_store", "dataset_cache")]
        PHASE39_WALLS["d_s"] = time.perf_counter() - t0
    rec = dict(card=card, rows=fr.nrow, host_budget_mb=host_mb,
               budget_mb=budget, wall_s=wall, stream=st, b1_launches=b1, differs=diff,
               spill_files_before_close=files_before,
               spill_dir_after_close=files_after, leaks=leaks)
    print(f"phase 39(d) disk tier on {card}: {json.dumps(rec)}", flush=True)
    if diff:
        bad.append(f"differs from the blocks lane in {diff}")
    if not (st["spilled_bytes"] and st["restored_bytes"]):
        bad.append("nothing spilled or restored")
    if files_after or leaks:
        bad.append(f"after close: {files_after} left, leaks {leaks}")
    if bad:
        raise AssertionError("phase 39(d): " + "; ".join(bad))
    return rec


def ooc_drf_path(dev, card, fr):
    """Phase 39(e): the streamed DRF on B2 against the blocks lane; returns
    (record, its store's first block row-major on the card)."""
    from h2o3_tpu_torch.models import dataset_cache as dsc
    from h2o3_tpu_torch.ops.histogram import row_major

    budget = _codes_mb(fr.nrow) / 4
    t0 = time.perf_counter()
    a, wall, peak, b1, b2 = _ooc_fit(dev, fr, OOC_DRF, "drf",
                                     H2O3_TREE_OOC=1,
                                     H2O3_STREAM_BUDGET_MB=budget)
    S = a._stream_stats["blocks"]
    (store,) = [s for e in dsc._ENTRIES.values() for s in e.blocks.values()
                if s.n_blocks == S]
    block = row_major(store.get(0), store.pack_bits)
    b, wall_b, _, _, _ = _ooc_fit(dev, fr, OOC_DRF, "drf", H2O3_TREE_OOC=0,
                                  H2O3_TREE_SHARD=1,
                                  H2O3_TREE_SHARD_BLOCKS=S)
    PHASE39_WALLS["e_s"] = time.perf_counter() - t0
    diff = _bitexact(a, b, fr)
    want = a.ntrees_built * OOC_DRF["max_depth"] * S
    rec = dict(card=card, rows=fr.nrow, S=S, wall_s=wall,
               blocks_lane_wall_s=wall_b, stream=a._stream_stats,
               b2_launches=b2, b1_launches=b1, oob_auc=float(a.auc()),
               differs=diff, device_peak_bytes=peak)
    print(f"phase 39(e) streamed DRF on {card}: {json.dumps(rec)}",
          flush=True)
    if diff or b2 != want or b1:
        raise AssertionError(
            f"phase 39(e): differs in {diff}; B2 {b2} (expected {want}), "
            f"B1 {b1}")
    return rec, block


def ooc_sweep_path(dev, card, fr):
    """Phase 39(f): a 3-candidate random grid with the cache and without
    it, then a GLM, K-Means and PCA on the frame's predictors."""
    from h2o3_tpu_torch.estimators import (
        H2OGeneralizedLinearEstimator, H2OGradientBoostingEstimator,
        H2OKMeansEstimator, H2OPrincipalComponentAnalysisEstimator)
    from h2o3_tpu_torch.models import dataset_cache as dsc
    from h2o3_tpu_torch.models.grid import H2OGridSearch

    x = [f"f{i}" for i in range(N_FEAT)]
    fr = fr.take(np.arange(fr.nrow))          # a frame the cache has not seen
    bad, rec = [], dict(card=card, rows=fr.nrow)
    base = H2OGradientBoostingEstimator(ntrees=10, seed=42, device=str(dev))
    crit = dict(strategy="RandomDiscrete", max_models=OOC_GRID_MODELS,
                seed=42)
    runs = {}
    t0 = time.perf_counter()
    for mode in ("1", "0"):
        c0 = dsc.snapshot()
        per = []
        real = H2OGradientBoostingEstimator._fit

        def counted(est, *a, **kw):
            s0 = dsc.snapshot()
            m = real(est, *a, **kw)
            s1 = dsc.snapshot()
            per.append({k: s1[k] - s0[k] for k in (
                "matrix_hits", "bins_hits", "device_hits", "matrix_misses",
                "bins_misses", "device_misses")})
            return m

        with ooc_env(H2O3_DATASET_CACHE=mode), \
                mock.patch.object(H2OGradientBoostingEstimator, "_fit",
                                  counted):
            t1 = time.perf_counter()
            grid = H2OGridSearch(base, OOC_GRID, search_criteria=crit)
            grid.train(x=x, y="label", training_frame=fr)
            torch.cuda.synchronize()
            runs[mode] = dict(models=[e.model for e in grid.models],
                              wall_s=time.perf_counter() - t1,
                              per_candidate=per,
                              combos=[e._grid_combo for e in grid.models])
    PHASE39_WALLS["f_grid_s"] = time.perf_counter() - t0
    diff = [_bitexact(a, b, fr) for a, b in zip(runs["1"]["models"],
                                                 runs["0"]["models"])]
    per = runs["1"]["per_candidate"]
    rec["grid"] = dict(cached_wall_s=runs["1"]["wall_s"],
                       uncached_wall_s=runs["0"]["wall_s"],
                       combos=runs["1"]["combos"], per_candidate=per,
                       differs=diff)
    print(f"phase 39(f) grid on {card}: {json.dumps(rec['grid'])}",
          flush=True)
    if runs["1"]["combos"] != runs["0"]["combos"] or any(diff):
        bad.append(f"cache-on and cache-off candidates differ: {diff}")
    hit = dict(matrix_hits=1, bins_hits=1, device_hits=1, matrix_misses=0,
               bins_misses=0, device_misses=0)
    if len(per) != OOC_GRID_MODELS or per[1] != hit or per[2] != hit:
        bad.append(f"candidates 2 and 3 did not hit every layer: {per}")
    t0 = time.perf_counter()
    s0 = dsc.snapshot()
    glm = H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                        device=str(dev))
    glm.train(x=x, y="label", training_frame=fr)
    s1 = dsc.snapshot()
    H2OKMeansEstimator(k=3, seed=42, device=str(dev)).train(
        x=x, training_frame=fr)
    s2 = dsc.snapshot()
    H2OPrincipalComponentAnalysisEstimator(
        k=3, transform="STANDARDIZE", device=str(dev)).train(
        x=x, training_frame=fr)
    torch.cuda.synchronize()
    s3 = dsc.snapshot()
    PHASE39_WALLS["f_std_s"] = time.perf_counter() - t0
    (entry,) = [e for e in dsc._ENTRIES.values() if e.frame_ref() is fr
                and len(e.key[4]) == N_FEAT]
    std = dict(glm={k: s1[k] - s0[k] for k in ("std_hits", "std_misses")},
               kmeans={k: s2[k] - s1[k] for k in ("std_hits", "std_misses")},
               pca={k: s3[k] - s2[k] for k in ("std_hits", "std_misses")},
               artifacts=sorted(k[0] for k in entry.std),
               glm_design_s={k: glm.model.fit_timings[k]
                             for k in ("pack_s", "h2d_s", "expand_s")})
    rec["std"] = std
    print(f"phase 39(f) std layer on {card}: {json.dumps(std)}", flush=True)
    # PCA's device matrix: the host layer under it and the device layer,
    # both hits (`device_matrix` hands the host matrix back with it)
    if std["pca"] != dict(std_hits=2, std_misses=0) \
            or std["artifacts"] != ["design", "dev", "host"]:
        bad.append(f"the std layer: {std}; expected PCA to take K-Means's "
                   "host and device artifacts beside the GLM's design")
    if bad:
        raise AssertionError("phase 39(f): " + "; ".join(bad))
    return rec


def ooc_small_checks(dev, card):
    """Phase 39(g): a streamed GBM at S = 4 (with a seeded weights column:
    the rows must reach the same leaves) and a streamed DRF (0/1 sums are
    exact: the forests must be equal), card against CPU on phase 5's
    fixture."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=names).asfactor("label")
    w = np.random.default_rng(4000).uniform(0.5, 1.5, 4000)
    frw = Frame({**{n: fr.vec(n) for n in fr.names},
                 "w": Vec(w.astype(np.float32))})
    knobs = dict(H2O3_TREE_OOC="1", H2O3_STREAM_BLOCKS=str(OOC_SMALL_S),
                 H2O3_STREAM_BUDGET_MB="0.01")
    cases = (("gbm_weighted", H2OGradientBoostingEstimator, frw,
              dict(ntrees=5, max_depth=4, seed=42, weights_column="w")),
             ("drf", H2ORandomForestEstimator, fr,
              dict(ntrees=5, max_depth=8, seed=42, hist_method="pallas")))
    bad, out = [], {}
    for name, cls, frame, params in cases:
        with ooc_env(**knobs):
            a = _pair_fit(cls, str(dev), params, frame)
            b = _pair_fit(cls, "cpu", params, frame)
        nodes, dv = _forest_diff(a, b)
        rows, dleaf = _leaves_diff(a, b, frame)
        dp = _pred_diff(a, b, frame)
        out[name] = dict(card=card, S=a._stream_stats["blocks"],
                         differing_nodes=nodes, max_value_diff=dv,
                         rows_in_other_leaves=rows,
                         max_leaf_value_diff=dleaf, max_predict_diff=dp)
        print(f"phase 39(g) {name} card vs cpu: {json.dumps(out[name])}",
              flush=True)
        same = (not nodes and dv <= 1e-5) if name == "drf" else not rows
        if not same or dleaf > 1e-5 or dp > 1e-5 \
                or a._stream_stats["blocks"] != OOC_SMALL_S:
            bad.append(f"{name}: {out[name]}")
    if bad:
        raise AssertionError("phase 39(g): card and CPU differ: "
                             + "; ".join(bad))
    return out


def b2_block_passes(dev, codes_rm, nbins, widths, seed):
    """B2 at each pass of `widths` on one block's row-major codes (the
    first a root pass with the in-bag 63.2 % weighted, the others about
    half): within rtol 1e-5 of `hist_plain_rows`, times with the L2
    flushed, the plain version's, one `index_add_`'s and the bytes bound.
    Returns one record a pass."""
    from h2o3_tpu_torch.ops import hist_cuda

    N, F = codes_rm.shape
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(widths):
        w = (rng.random(N) < (0.632 if i == 0 else 0.5)).astype(np.float32)
        g = rng.normal(size=N).astype(np.float32)
        vals = torch.from_numpy(np.stack([w, g * w, w])).to(dev)
        node = torch.from_numpy(rng.integers(0, L, N, dtype=np.int32)).to(dev)
        got = hist_cuda.hist_build_rows(codes_rm, node, vals, L, nbins)
        ref = hist_cuda.hist_plain_rows(codes_rm, node, vals, L, nbins)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        n_w = int(w.sum())
        rec = dict(L=L, weighted_rows=n_w,
                   max_abs_err=float((got - ref).abs().max()))
        rec["ms"] = time_ms_cold(lambda: hist_cuda.hist_build_rows(
            codes_rm, node, vals, L, nbins), reps=10, warmup=2)
        rec["plain_ms"] = time_ms(lambda: hist_cuda.hist_plain_rows(
            codes_rm, node, vals, L, nbins), reps=3, warmup=1)
        rec["library_ms"] = bm_library_ms(dev, codes_rm.t().contiguous(),
                                          node, vals, L, nbins)
        rec["bound_ms"], rec["bytes"] = bound_ms_of(
            n_w, L, n_feat=F, nbins=nbins, n_rows=N)
        out.append(rec)
        del got, ref, node, vals
    return out


def ooc_path(dev, card):
    """Phase 39: (a)-(g) in turn, then B1 and B2 at the block shapes the
    streamed fits ran. Returns the kernels line's two entries."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import dataset_cache as dsc

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    X, y = make_higgs_like(OOC_ROWS)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=names).asfactor("label")
    del X
    Xv, y_v = make_higgs_like(OOC_HOLDOUT, seed=1)
    fv = Frame.from_numpy(np.column_stack([Xv, y_v]),
                          names=names).asfactor("label")
    PHASE39_WALLS["frames_s"] = time.perf_counter() - t0
    rec_ac, block_fm = ooc_higgs_path(dev, card, fr, fv, y_v)
    fr1 = fr.take(np.arange(OOC_SMALL))
    del fr
    dsc.clear()
    rec_d = ooc_disk_path(dev, card, fr1)
    rec_e, block_rm = ooc_drf_path(dev, card, fr1)
    rec_f = ooc_sweep_path(dev, card, fr1)
    del fr1
    dsc.clear()
    t0 = time.perf_counter()
    rec_g = ooc_small_checks(dev, card)
    PHASE39_WALLS["g_s"] = time.perf_counter() - t0
    PHASE39_WALLS["fits_s"] = time.perf_counter() - t_phase
    # the kernels at the block shapes: B1 over one block of (a)'s codes at
    # each of a depth-6 tree's six passes, B2 over one block of (e)'s at
    # each of a depth-12 tree's twelve
    b1 = b1_passes(dev, block_fm, NBINS, OOC_LEVELS, 39)
    b2 = b2_block_passes(dev, block_rm, NBINS,
                         [1] + [2 ** d for d in range(OOC_DRF["max_depth"]
                                                      - 1)], 139)
    PHASE39_WALLS["phase_s"] = time.perf_counter() - t_phase
    for tag, recs, n in (("B1", b1, block_fm.shape[1]),
                         ("B2", b2, block_rm.shape[0])):
        print(f"phase 39 {tag} at one block ({n} rows) on {card}: "
              + json.dumps(recs), flush=True)
    entries = []
    for name, recs, launches, replaces in (
            ("hist_factored_stream", b1, rec_ac["a"]["b1_launches"],
             "h2o3_tpu/ops/hist_pallas.py:103"),
            ("hist_rows_stream", b2, rec_e["b2_launches"],
             "h2o3_tpu/ops/hist_pallas.py:174")):
        entries.append(dict(
            name=name, route="cuda", source="h2o3_tpu_torch/csrc/hist.cu",
            replaces=replaces, launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs), bound_by="bytes",
            library_ms=sum(r["library_ms"] for r in recs)))
    print(f"phase 39 record on {card}: " + json.dumps(dict(
        d=rec_d, e=rec_e, f=rec_f, g=rec_g)), flush=True)
    return entries


# -- phase 40: the multi-process tree lane -------------------------------------
#
# Ranks are fresh interpreters started through the port's launcher
# (`python -m h2o3_tpu_torch.parallel.launcher --coordinator file://…
# --nprocs N --rank r chip_smoke.py --pod-rank …`), sharing the card over
# gloo (NCCL refuses two ranks on one device), rendezvousing through a
# FileStore in a temporary directory. Each rank draws phase 39's HIGGS
# frame from its seed, keeps only its own ingest shard of the rows (uneven,
# so the canonical exchange moves rows), fits, and writes its record; the
# smoke holds it against its own one-process blocks-lane fit at S = 8.
POD_ROWS_FROM, POD_ROWS, POD_SPLIT = 11_000_000, 1_000_000, 499_993
POD_S = 8
POD_GBM = dict(ntrees=20, max_depth=6, learn_rate=0.1, nbins=20,
               histogram_type="UniformAdaptive", seed=42,
               score_tree_interval=5, stopping_rounds=2,
               stopping_tolerance=0.01)
POD_DRF = dict(ntrees=5, max_depth=12, hist_method="pallas",
               sample_rate=0.632, seed=42, score_tree_interval=1)
# (c): four ranks on 200,000 of the rows, QuantilesGlobal
POD_QG_ROWS = 200_000
POD_QG_SPLITS = [0, 49_999, 100_003, 150_000, POD_QG_ROWS]
POD_QG = dict(ntrees=10, max_depth=6, learn_rate=0.1, nbins=20,
              histogram_type="QuantilesGlobal", seed=42,
              score_tree_interval=5)
POD_CASES = {"gbm": ("gbm", POD_GBM), "drf": ("drf", POD_DRF),
             "qg": ("gbm", POD_QG)}
# (e)-(g): the estimator engine on a pod, fitted by (a)'s ranks after (a)
# and (b), each held against the smoke's own one-process blocks-lane fit
# at S = 8 (H2O3_EST_SHARD=1; the CV of (g) under H2O3_TREE_SHARD=1 and
# H2O3_CV_REBIN=1, the fold path a pod takes). (e) config 2's Airlines
# logistic GLM (phase 17's generator, 217 slopes and the intercept) with
# p-values and 3 folds; (f) K-Means at UNSUP_KM and a GramSVD PCA at
# k = UNSUP_PCA_K (DEMEAN, whose mean a pod takes from the gathered
# matrix) on phase 34's Covertype-shaped predictors; (g) (a)'s GBM with
# 3 folds. Each cuts its rows for the phase's time (+30 s at most)
POD_AIR_ROWS, POD_AIR_SPLIT = 200_000, 99_991
POD_COV_ROWS, POD_COV_SPLIT = 200_000, 99_989
POD_CV_ROWS, POD_CV_SPLIT = 200_000, 99_997
POD_GLM = dict(family="binomial", solver="IRLSM", lambda_=0.0,
               compute_p_values=True, nfolds=3, seed=42)
POD_PCA = dict(k=UNSUP_PCA_K, transform="DEMEAN", pca_method="GramSVD")
POD_GBM_CV = dict(POD_GBM, nfolds=3)
# (e)'s standardization takes the pod's global f64 moments, not the
# one-process np.nanmean bits: β, its standard errors, the fold β, the
# holdouts and the CV metrics within POD_EST_TOL·max(1, |x|), p-values
# within POD_EST_TOL; (f) within UNSUP_SMALL_TOLS
POD_EST_TOL = 1e-5
# (h)-(j): item 9, part 1b's fits on the same ranks after (g), each held
# against the smoke's one-process blocks-lane fit at S = 8. (h) phase 18's
# λ search on (e)'s rows with a validation frame of POD_AIR_VALID more
# generated rows, split unevenly over the ranks; (i) phase 30's 7-class
# GLM (MN_GLM) on (f)'s rows and their labels; (j) K-Means from
# POD_KM_POINTS rows of (f)'s frame drawn by seed (unstandardized: the
# points are those rows), PCA Randomized and SVD (keep_u) on phase 34's
# MNIST-shaped pixels, nothing cut but Power's vectors (POD_POWER_NV of
# UNSUP_PCA_K). (h) and (i) standardize, so they are held as (e) is: the
# λ list and λ_best's index equal, β and the path deviances within
# POD_EST_TOL; (i)'s centred β and probabilities within the CPU tests'
# POD_MN_TOLS; (j) bit for bit
POD_AIR_VALID, POD_AIR_VALID_SPLIT = 50_000, 24_989
POD_LS = dict(family="binomial", alpha=0.5, lambda_search=True,
              nlambdas=AIR_NLAMBDA)
POD_MN_TOLS = dict(beta=3e-4, probs=1e-4)
POD_KM_POINTS, POD_KM_SEED = COV_K, 40
POD_KMUP = dict(k=COV_K, standardize=False,
                max_iterations=UNSUP_KM["max_iterations"])
POD_MNIST_SPLIT = 29_989
POD_PCAR = dict(k=UNSUP_PCA_K, transform="DEMEAN", pca_method="Randomized",
                seed=42)
POD_POWER_NV = 10
POD_SVD = (("GramSVD", UNSUP_PCA_K), ("Randomized", UNSUP_PCA_K),
           ("Power", POD_POWER_NV))
POD_EST_CASES = ("glm", "kmpca", "gbmcv", "ls", "mn", "kmup", "pcasvd")
# each case's leg; (j) is two cases, K-Means on (f)'s frame and PCA/SVD on
# the pixels
POD_EST_TAGS = dict(glm="e", kmpca="f", gbmcv="g", ls="h", mn="i",
                    kmup="j", pcasvd="j")
# the recorded path of each fit of the new cases: one process / a pod
POD_EST_PATHS = dict(ls=("fused_path", "fused_path"),
                     mn=("lbfgs", "lbfgs"))
POD_TIMEOUT_S = 150
# how long a rank waits for its launch's go: (c)'s ranks wait through the
# one-process fits and every leg of (a)'s launch
POD_GO_TIMEOUT_S = 600
PHASE40_WALLS: dict = {}


def pod_splits(case: str, nranks: int) -> list:
    """The ranks' first ingest rows (and the end) of `case`'s frame."""
    if case == "qg":
        return POD_QG_SPLITS if nranks == 4 else [0, POD_QG_ROWS]
    n, split = {"glm": (POD_AIR_ROWS, POD_AIR_SPLIT),
                "ls": (POD_AIR_ROWS, POD_AIR_SPLIT),
                "kmpca": (POD_COV_ROWS, POD_COV_SPLIT),
                "mn": (POD_COV_ROWS, POD_COV_SPLIT),
                "kmup": (POD_COV_ROWS, POD_COV_SPLIT),
                "pcasvd": (DL_ROWS, POD_MNIST_SPLIT),
                "gbmcv": (POD_CV_ROWS, POD_CV_SPLIT)}.get(
                    case, (POD_ROWS, POD_SPLIT))
    return [0, split, n] if nranks == 2 else [0, n]


def pod_valid_rows(nranks: int, rank: int) -> tuple:
    """The validation rows [lo, hi) of (h)'s rank `rank` of `nranks` (1 or
    2)."""
    cuts = ([0, POD_AIR_VALID_SPLIT, POD_AIR_VALID] if nranks == 2
            else [0, POD_AIR_VALID])
    return cuts[rank], cuts[rank + 1]


def pod_kind(case: str) -> str:
    """Which frame `case` fits (cases of one kind on the same rows share
    it): "air", "airv" (the Airlines rows and a validation frame), "cov",
    "covp" (the Covertype-shaped rows and (j)'s seeded points of the whole
    frame), "covy" (the rows with their labels), "mnist" or "higgs"."""
    return {"glm": "air", "ls": "airv", "kmpca": "cov", "kmup": "covp",
            "mn": "covy", "pcasvd": "mnist"}.get(case, "higgs")


def pod_source(kind: str, cache: dict):
    """The whole of one data source, drawn from its seed once a process:
    the HIGGS rows (X, y), the Airlines frame ("air") and (h)'s validation
    frame ("airval"), the Covertype-shaped (X, y) ("cov"), or the
    MNIST-shaped frame."""
    if kind not in cache:
        if kind == "air":
            cache[kind] = make_airlines_like(POD_AIR_ROWS, 0)[0]
        elif kind == "airval":
            cache[kind] = make_airlines_like(POD_AIR_VALID, 7)[0]
        elif kind == "cov":
            cache[kind] = make_covtype_like(POD_COV_ROWS, 5)
        elif kind == "mnist":
            cache[kind] = make_mnist_like(DL_ROWS, 0)
        else:
            cache[kind] = make_higgs_like(POD_ROWS)
    return cache[kind]


def pod_case_frame(case: str, lo: int, hi: int, cache: dict,
                   vrows=(0, POD_AIR_VALID)):
    """Rows [lo, hi) of `case`'s data as a Frame of those rows alone (the
    Airlines and MNIST rows keep the whole frame's domains); (h)'s is the
    pair (rows, validation rows `vrows`), (j)'s K-Means (rows, user
    points, the columns they span)."""
    from h2o3_tpu_torch.frame.frame import Frame

    kind = pod_kind(case)
    if kind in ("air", "airv", "mnist"):
        fr = pod_source("mnist" if kind == "mnist" else "air",
                        cache).take(np.arange(lo, hi))
        if kind == "airv":
            return fr, pod_source("airval", cache).take(np.arange(*vrows))
        return fr
    if kind in ("cov", "covp", "covy"):
        X, y = pod_source("cov", cache)
        if kind == "cov":
            return Frame.from_numpy(X[lo:hi], names=COV_NAMES)
        if kind == "covp":
            # the points in the design's columns: the frame's columns not
            # constant over the whole frame (the rest are ignored)
            keep = np.ptp(X, axis=0) > 0
            pts = X[np.random.default_rng(POD_KM_SEED).choice(
                len(X), POD_KM_POINTS, replace=False)][:, keep]
            return (Frame.from_numpy(X[lo:hi], names=COV_NAMES), pts,
                    [n for n, k in zip(COV_NAMES, keep) if k])
        return Frame.from_numpy(
            np.column_stack([X[lo:hi], y[lo:hi].astype(np.float32)]),
            names=COV_NAMES + ["cover"]).asfactor("cover")
    return pod_frame(lo, hi, *pod_source("higgs", cache))


def pod_frame(lo: int, hi: int, X=None, y=None):
    """Rows [lo, hi) of phase 39's HIGGS frame as a Frame of those rows
    alone (drawn from the seed when X is not given)."""
    from h2o3_tpu_torch.frame.frame import Frame

    if X is None:
        X, y = make_higgs_like(POD_ROWS)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    return Frame.from_numpy(np.column_stack([X[lo:hi], y[lo:hi]]),
                            names=names).asfactor("label")


def pod_record(model, fr) -> dict:
    """What a pod fit must share with its one-process twin: the forest,
    tree count, scoring history and varimp; and `predict` on `fr`."""
    f = [t.cpu().numpy() for t in model.forest[0]]
    hist = model.scoring_history
    return dict(
        feat=f[0], bin=f[1], thr=f[2], split=f[3], value=f[4],
        ntrees=np.asarray(model.ntrees_built),
        sh=np.asarray([[e["number_of_trees"], e["training_deviance"]]
                       for e in hist], np.float64),
        vi_names=np.asarray([r[0] for r in model.varimp_table]),
        vi_gain=np.asarray([r[1] for r in model.varimp_table], np.float64),
        p1=np.asarray(model.predict(fr).vec("1").data, np.float64))


def pod_fit(dev, case: str, fr) -> tuple:
    """(model, record) of one fit of `case` on `fr`: the wall, the B1, B2
    and gather counts (zeroed just before), the allocator's peak over the
    fit on `dev`, then `predict`'s forest launches."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda
    from h2o3_tpu_torch.parallel import mesh

    if case in POD_EST_CASES:
        return None, pod_est_fit(dev, case, fr)
    algo, params = POD_CASES[case]
    cls = (H2OGradientBoostingEstimator if algo == "gbm"
           else H2ORandomForestEstimator)
    zero_counts()
    mesh.GATHER_STATS.update(calls=0, bytes=0, seconds=0.0)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    m = cls(device=str(dev), **params).train(y="label",
                                             training_frame=fr).model
    torch.cuda.synchronize(dev)
    rec = dict(wall_s=time.perf_counter() - t0, fit_timings=m.fit_timings,
               b1=hist_cuda.launches, b2=hist_cuda.launches_rows,
               gathers=dict(mesh.GATHER_STATS),
               device_peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
               ntrees=m.ntrees_built, pod=getattr(m, "_pod", None))
    score_cuda.launches = 0
    rec.update(pod_record(m, fr))
    rec["score_launches"] = score_cuda.launches
    return m, rec


def _cv_record(model) -> dict:
    """A CV parent's holdouts (this process's rows), cross-validation
    metrics and each fold model's validation AUC."""
    xm = model.cross_validation_metrics
    return dict(holdout=np.asarray(model._cv_holdout_pred, np.float64),
                xval=np.asarray([xm.auc, xm.logloss], np.float64),
                fold_auc=np.asarray([f.validation_metrics.auc for f in
                                     model.cross_validation_models]))


def pod_est_fit(dev, case: str, fr) -> dict:
    """The record of one (e)-(g) fit on `fr`: its wall, every kernel's
    launches and the gathers (zeroed just before), the engine's paths and
    what the comparison reads."""
    from h2o3_tpu_torch.estimators import (
        H2OGeneralizedLinearEstimator, H2OGradientBoostingEstimator,
        H2OKMeansEstimator, H2OPrincipalComponentAnalysisEstimator)
    from h2o3_tpu_torch.models import estimator_engine as est
    from h2o3_tpu_torch.parallel import mesh

    tf32_off()
    zero_counts()
    mesh.GATHER_STATS.update(calls=0, bytes=0, seconds=0.0)
    t0 = time.perf_counter()
    rec = {}
    if case == "glm":
        m = H2OGeneralizedLinearEstimator(device=str(dev), **POD_GLM).train(
            y="IsDepDelayed", training_frame=fr).model
        rec.update(beta=np.asarray(m.beta, np.float64),
                   stderr=np.asarray(m.stderr, np.float64),
                   pv=np.asarray([r["p_value"]
                                  for r in m.coef_with_p_values()]),
                   fold_beta=np.stack([f.beta for f in
                                       m.cross_validation_models]),
                   path=m.fitplan["path"], iters=m.fitplan["iterations"],
                   fit_timings=m.fit_timings, **_cv_record(m))
    elif case == "kmpca":
        km = H2OKMeansEstimator(device=str(dev), **UNSUP_KM).train(
            training_frame=fr).model
        km_path = est.est_stats()["plans"][-1]["path"]
        km_s = time.perf_counter() - t0
        pca = H2OPrincipalComponentAnalysisEstimator(
            device=str(dev), **POD_PCA).train(training_frame=fr).model
        pod_km, pod_pca = (getattr(km, "_pod", {}),
                           getattr(pca, "_pod", {}))
        rec.update(centers=np.asarray(km.centers_std, np.float64),
                   wss=float(km.fit_wss), km_iters=int(km.iterations),
                   evals=np.asarray(pca.eigenvalues, np.float64),
                   evecs=np.asarray(pca.eigenvectors, np.float64),
                   path=km_path,
                   pca_path=est.est_stats()["plans"][-1]["path"],
                   km_wall_s=km_s,
                   init_gather_bytes=pod_km.get("init_gather_bytes", 0),
                   demean_gather_bytes=pod_pca.get("demean_gather_bytes",
                                                   0))
    elif case in ("ls", "mn", "kmup", "pcasvd"):
        rec.update(pod_est_fit_1b(dev, case, fr))
    else:
        m = H2OGradientBoostingEstimator(device=str(dev),
                                         **POD_GBM_CV).train(
            y="label", training_frame=fr).model
        folds = m.cross_validation_models
        for i, f in enumerate(folds):
            for name, t in zip(("feat", "bin", "thr", "split", "value"),
                               f.forest[0]):
                rec[f"fold{i}_{name}"] = t.cpu().numpy()
        rec.update(ntrees=[m.ntrees_built] + [f.ntrees_built
                                              for f in folds],
                   **_cv_record(m))
    torch.cuda.synchronize(dev)
    rec.update(wall_s=time.perf_counter() - t0, kernels=kernel_counts(),
               gathers=dict(mesh.GATHER_STATS))
    return rec


def pod_est_fit_1b(dev, case: str, fr) -> dict:
    """The record of one (h)-(j) fit: what the comparison reads, and of
    each fit its wall, split (`fit_timings`), recorded plan and gathers
    (count, bytes, seconds: the difference of `mesh.GATHER_STATS` over
    it)."""
    from h2o3_tpu_torch.estimators import (
        H2OGeneralizedLinearEstimator, H2OKMeansEstimator,
        H2OPrincipalComponentAnalysisEstimator,
        H2OSingularValueDecompositionEstimator)
    from h2o3_tpu_torch.models import estimator_engine as est
    from h2o3_tpu_torch.parallel import mesh

    fits, rec = {}, {}

    def timed(name, make):
        g0 = dict(mesh.GATHER_STATS)
        t0 = time.perf_counter()
        m = make()
        torch.cuda.synchronize(dev)
        plan = est.est_stats()["plans"][-1]
        fits[name] = dict(
            wall_s=time.perf_counter() - t0, fit_timings=m.fit_timings,
            plan=[plan["path"], plan["n_shards"], plan["n_devices"]],
            gathers={k: mesh.GATHER_STATS[k] - g0[k] for k in g0})
        return m

    if case == "ls":
        tr, fv = fr
        m = timed("glm_lambda_search", lambda: H2OGeneralizedLinearEstimator(
            device=str(dev), **POD_LS).train(
            y="IsDepDelayed", training_frame=tr,
            validation_frame=fv).model)
        rec.update(beta=np.asarray(m.beta, np.float64),
                   lambdas=np.asarray([lv for lv, _ in m.full_path]),
                   devs=np.asarray(m.fitplan["path_deviances"]),
                   best=int(m.fitplan["best_index"]),
                   irls_iterations=int(m.fitplan["irls_iterations"]))
    elif case == "mn":
        m = timed("glm_multinomial", lambda: H2OGeneralizedLinearEstimator(
            device=str(dev), **MN_GLM).train(y="cover",
                                             training_frame=fr).model)
        rec.update(beta=np.asarray(m.beta, np.float64),
                   probs=m._score(fr, by_columns=True),
                   lbfgs_steps=int(m.fitplan["iterations"]),
                   func_evals=int(m.fitplan["func_evals"]))
    elif case == "kmup":
        fr, pts, x = fr
        m = timed("kmeans_user_points", lambda: H2OKMeansEstimator(
            device=str(dev), user_points=pts, **POD_KMUP).train(
            x=x, training_frame=fr).model)
        rec.update(centers=np.asarray(m.centers_std, np.float64),
                   wss=float(m.fit_wss), km_iters=int(m.iterations))
    else:
        pixels = [f"C{j + 1}" for j in range(DL_SIDE * DL_SIDE)]
        m = timed("pca_randomized",
                  lambda: H2OPrincipalComponentAnalysisEstimator(
                      device=str(dev), **POD_PCAR).train(
                      x=pixels, training_frame=fr).model)
        rec.update(evals=np.asarray(m.eigenvalues, np.float64),
                   evecs=np.asarray(m.eigenvectors, np.float64))
        for method, nv in POD_SVD:
            m = timed(f"svd_{method}",
                      lambda: H2OSingularValueDecompositionEstimator(
                          device=str(dev), nv=nv, svd_method=method,
                          keep_u=True, seed=42).train(
                          x=pixels, training_frame=fr).model)
            rec.update({f"d_{method}": np.asarray(m.d, np.float64),
                        f"v_{method}": np.asarray(m.v, np.float64),
                        f"u_{method}": np.asarray(m.u, np.float64)})
    rec["fits"] = fits
    return rec


def pod_warm(dev, cases) -> float:
    """Before its go, a rank whose cases hold (i) runs the multinomial
    loss and L-BFGS on seeded tensors of its blocks' shapes, outside any
    fit and any collective: a process's first launches of those kernels
    took 8-10 s over the warm fit's ≈1 s in a dev call (PR 28), the cost
    phase 30's twice-run fit pays once in the smoke's own process. Returns
    its wall."""
    if "mn" not in cases:
        return 0.0
    from h2o3_tpu_torch.models import estimator_engine as est, glm

    t0 = time.perf_counter()
    rows = est.pad_rows(POD_COV_ROWS, POD_S) // POD_S
    p = len(COV_NAMES) + 1
    g = torch.Generator(device=dev).manual_seed(0)
    blocks = [(torch.randn((rows, p), device=dev, generator=g),
               torch.randint(0, COV_K, (rows,), device=dev, generator=g),
               torch.ones(rows, device=dev)) for _ in range(POD_S // 2)]
    fun = glm._softmax_fn(None, None, None, MN_GLM["lambda_"],
                          rows * len(blocks), blocks, None)
    glm._lbfgs(fun, torch.zeros((COV_K, p), device=dev), 20)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def pod_rank_main(argv) -> int:
    """A rank's entry (the launcher runs `chip_smoke.py --pod-rank OUT
    CASES T0 GO`, T0 the launch's clock): draw the frame, keep this rank's
    ingest rows (cases with the same rows share one frame), wait for the
    file GO, then fit each case and write its record to
    OUT/<case>_<rank>.npz."""
    from h2o3_tpu_torch import device as devlib
    from h2o3_tpu_torch.ops import hist_cuda, score_cuda
    from h2o3_tpu_torch.parallel import distdata, mesh
    from h2o3_tpu_torch.runtime import memory_ledger

    out_dir, cases, t_launch, go = (argv[0], argv[1].split(","),
                                    float(argv[2]), argv[3])
    torch.set_num_threads(1)
    c = mesh.cloud()
    dev = devlib.resolve(None)
    # the smoke built both libraries before starting any rank: load them
    hist_cuda.build()
    score_cuda.build()
    started_s = time.time() - t_launch
    src = {}
    rows = {case: tuple(pod_splits(case, c.size)[c.self_idx:c.self_idx + 2])
            for case in cases}
    frames = {}
    for case in cases:
        key = (pod_kind(case),) + rows[case]
        if key not in frames:
            frames[key] = pod_case_frame(
                case, *rows[case], src,
                vrows=(pod_valid_rows(c.size, c.self_idx) if case == "ls"
                       else None))
    del src
    frame_s = time.time() - t_launch
    warm_s = pod_warm(dev, cases)
    deadline = time.monotonic() + POD_GO_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no go file {go}")
        time.sleep(0.02)
    go_s = time.time() - t_launch
    for case in cases:
        fr = frames[(pod_kind(case),) + rows[case]]
        _, rec = pod_fit(dev, case, fr)
        train = fr[0] if isinstance(fr, tuple) else fr
        rec.update(rank=c.self_idx, ranks=c.size, backend=c.backend,
                   device=str(dev), row_off=distdata.row_offset(train.nrow),
                   ledger_peak=memory_ledger.peak(), started_s=started_s,
                   frame_s=frame_s, warm_s=warm_s, go_s=go_s,
                   done_s=time.time() - t_launch)
        arrays = {k: v for k, v in rec.items() if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in rec.items() if k not in arrays}
        np.savez(os.path.join(out_dir, f"{case}_{c.self_idx}.npz"),
                 meta=json.dumps(meta, default=str), **arrays)
    return 0


def pod_start(nranks: int, cases, tmp: str, tag: str, env=None) -> dict:
    """Start `nranks` ranks of this script through the launcher. Each
    joins its group, loads the kernels and builds its frames, then waits
    for the launch's go file (`pod_join` writes it), so the ranks' start
    overlaps other work while their fits run alone on the card. `env`
    adds to the ranks' environment."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict({k: v for k, v in os.environ.items() if k not in _OOC_KNOBS},
               **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    launch = dict(tag=tag, nranks=nranks, procs=[],
                  go=os.path.join(tmp, f"go_{tag}"))
    t_launch = time.time()
    for r in range(nranks):
        log = open(os.path.join(tmp, f"log_{tag}_{r}.txt"), "w")
        launch["procs"].append((subprocess.Popen(
            [sys.executable, "-m", "h2o3_tpu_torch.parallel.launcher",
             "--coordinator", f"file://{os.path.join(tmp, 'store_' + tag)}",
             "--nprocs", str(nranks), "--rank", str(r),
             os.path.join(root, "chip_smoke.py"), "--pod-rank", tmp,
             ",".join(cases), repr(t_launch), launch["go"]],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return launch


def pod_stop(launch: dict) -> None:
    """Kill every rank of `launch` still alive; close the logs."""
    for p, log in launch["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
        if not log.closed:
            log.close()


def pod_go(launch: dict) -> None:
    """Write the launch's go file (once): its ranks start fitting."""
    if "t_go" not in launch:
        launch["t_go"] = time.perf_counter()
        with open(launch["go"], "w"):
            pass


def pod_join(launch: dict) -> float:
    """Write the launch's go file if `pod_go` has not, wait for its ranks
    under POD_TIMEOUT_S, stop them all, and raise with a failed rank's log;
    returns the wall from go to the last exit."""
    procs = launch["procs"]
    pod_go(launch)
    deadline = time.monotonic() + POD_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            # a failed rank leaves its peers in a collective: stop now
            if any(p.poll() not in (None, 0) for p, _ in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        pod_stop(launch)
    for r, (p, log) in enumerate(procs):
        if p.returncode != 0:
            with open(log.name) as f:
                tail = f.read()[-4000:]
            raise AssertionError(
                f"phase 40({launch['tag']}): rank {r} of {launch['nranks']} "
                f"exited {p.returncode}:\n{tail}")
    return time.perf_counter() - launch["t_go"]


def pod_load(tmp: str, case: str, rank: int) -> dict:
    with np.load(os.path.join(tmp, f"{case}_{rank}.npz")) as z:
        rec = {k: z[k] for k in z.files if k != "meta"}
        rec.update(json.loads(str(z["meta"])))
    return rec


def pod_diff(one: dict, pod: dict, lo: int, hi: int) -> list:
    """What differs between a rank's fit and the one-process fit: forest,
    tree count, scoring history, varimp, and `predict` on the rank's
    ingest rows [lo, hi) (empty when they agree bit for bit)."""
    out = [k for k in ("feat", "bin", "thr", "split", "value", "ntrees",
                       "sh", "vi_names", "vi_gain")
           if not np.array_equal(one[k], pod[k])]
    if pod["row_off"] != lo or len(pod["p1"]) != hi - lo:
        out.append(f"rows {pod['row_off']}+{len(pod['p1'])}, not {lo}:{hi}")
    elif not np.array_equal(one["p1"][lo:hi], pod["p1"]):
        out.append("predict")
    return out


def pod_leg(card, tmp, tag, case, nranks, one, per_rank, bad, rec, wall):
    """Hold every rank's record of `case` (from a launch of `wall` s)
    against the one-process record `one`, check each rank's launches
    (`per_rank`: {count: expected}) and print the leg."""
    splits = pod_splits(case, nranks)
    ranks = []
    for r in range(nranks):
        p = pod_load(tmp, case, r)
        diff = pod_diff(one, p, splits[r], splits[r + 1])
        g = p["gathers"]
        ranks.append(dict(
            rank=r, backend=p["backend"], device=p["device"],
            rows=splits[r + 1] - splits[r], wall_s=p["wall_s"],
            fit_timings=p["fit_timings"], b1=p["b1"], b2=p["b2"],
            score_launches=p["score_launches"],
            device_peak_bytes=p["device_peak_bytes"],
            ledger_host_peak=p["ledger_peak"]["host_bytes"],
            started_s=p["started_s"], frame_s=p["frame_s"],
            go_s=p["go_s"], done_s=p["done_s"],
            gathers=g["calls"], gathered_bytes=g["bytes"],
            gather_s=g["seconds"],
            gather_ms_mean=1e3 * g["seconds"] / max(g["calls"], 1),
            differs=diff))
        if diff:
            bad.append(f"({tag}) rank {r} differs from the one-process fit "
                       f"in {diff}")
        for k, want in per_rank.items():
            if p[k] != want:
                bad.append(f"({tag}) rank {r}: {k} {p[k]}, expected {want}")
    rec[tag] = dict(ranks=nranks, launch_wall_s=wall,
                    one_process=dict(wall_s=one["wall_s"], b1=one["b1"],
                                     b2=one["b2"],
                                     device_peak_bytes=one[
                                         "device_peak_bytes"],
                                     ntrees=one["ntrees"]),
                    per_rank=ranks)
    print(f"phase 40({tag}) {nranks} ranks, {case}, on {card}: "
          + json.dumps(rec[tag], default=str), flush=True)
    return ranks


def _max_rel(a, b) -> float:
    """max |a − b| / max(1, |b|) over the entries (0 for two empties)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def _evec_err(a, b) -> float:
    """Largest entrywise gap of two eigenvector sets up to each column's
    sign."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    sign = np.sign((a * b).sum(axis=0))
    sign[sign == 0] = 1.0
    return float(np.max(np.abs(a * sign - b))) if a.size else 0.0


def pod_est_diff(case: str, one: dict, pod: dict, lo: int, hi: int):
    """(errors, what breaks its bar) of a rank's (e)-(g) record against
    the one-process record; `holdout` is the rank's ingest rows
    [lo, hi)."""
    ho = one["holdout"][lo:hi] if "holdout" in one else None
    if case == "glm":
        errs = dict(beta=_max_rel(pod["beta"], one["beta"]),
                    stderr=_max_rel(pod["stderr"], one["stderr"]),
                    p_value=float(np.max(np.abs(pod["pv"] - one["pv"]))),
                    fold_beta=_max_rel(pod["fold_beta"], one["fold_beta"]),
                    holdout=_max_rel(pod["holdout"], ho),
                    xval=_max_rel(pod["xval"], one["xval"]),
                    fold_auc=_max_rel(pod["fold_auc"], one["fold_auc"]))
        return errs, [k for k, v in errs.items() if not v <= POD_EST_TOL]
    if case == "kmpca":
        t = UNSUP_SMALL_TOLS
        errs = dict(centers=float(np.max(np.abs(pod["centers"]
                                                - one["centers"]))),
                    wss=abs(pod["wss"] - one["wss"]) / abs(one["wss"]),
                    evals=float(np.max(np.abs(pod["evals"] - one["evals"])
                                       / np.abs(one["evals"]))),
                    evecs=_evec_err(pod["evecs"], one["evecs"]))
        bars = dict(centers=t["center"], wss=t["ss"], evals=t["eig_rel"],
                    evecs=t["eig_abs"])
        return errs, [k for k, v in errs.items() if not v <= bars[k]]
    if case == "ls":
        errs = dict(beta=_max_rel(pod["beta"], one["beta"]),
                    lambdas=_max_rel(pod["lambdas"], one["lambdas"]),
                    devs=_max_rel(pod["devs"], one["devs"]))
        broken = [k for k, v in errs.items() if not v <= POD_EST_TOL]
        errs.update(best=[pod["best"], one["best"]],
                    irls_iterations=[pod["irls_iterations"],
                                     one["irls_iterations"]])
        return errs, broken + (["best"] if pod["best"] != one["best"]
                               else [])
    if case == "mn":
        pb, ob = pod["beta"], one["beta"]
        errs = dict(beta=float(np.max(np.abs((pb - pb.mean(0))
                                             - (ob - ob.mean(0))))),
                    probs=float(np.max(np.abs(pod["probs"]
                                              - one["probs"][lo:hi]))))
        broken = [k for k, v in errs.items() if not v <= POD_MN_TOLS[k]]
        errs.update(lbfgs_steps=[pod["lbfgs_steps"], one["lbfgs_steps"]],
                    func_evals=[pod["func_evals"], one["func_evals"]])
        return errs, broken
    if case in ("kmup", "pcasvd"):
        keys = (["centers", "wss", "km_iters"] if case == "kmup" else
                ["evals", "evecs"] + [f"{x}_{m}" for m, _ in POD_SVD
                                      for x in ("d", "v")])
        same = {k: bool(np.array_equal(pod[k], one[k])) for k in keys}
        for m, _ in POD_SVD if case == "pcasvd" else ():
            same[f"u_{m}"] = bool(np.array_equal(pod[f"u_{m}"],
                                                 one[f"u_{m}"][lo:hi]))
        return ({"bit_equal": all(same.values())},
                [k for k, v in same.items() if not v])
    keys = [k for k in one if k.startswith("fold") and k != "fold_auc"]
    same = {k: bool(np.array_equal(pod.get(k), one[k])) for k in keys}
    same.update(holdout=bool(np.array_equal(pod["holdout"], ho)),
                xval=bool(np.array_equal(pod["xval"], one["xval"])),
                fold_auc=bool(np.array_equal(pod["fold_auc"],
                                             one["fold_auc"])),
                ntrees=list(pod["ntrees"]) == list(one["ntrees"]))
    return ({"bit_equal": all(same.values())},
            [k for k, v in same.items() if not v])


def pod_est_leg(card, tmp, tag, case, one, bad, rec, wall):
    """Hold both ranks' (e)-(g) records of `case` against the one-process
    record `one`, check the kernels each launched, and print the leg."""
    splits = pod_splits(case, 2)
    ranks = []
    for r in range(2):
        p = pod_load(tmp, case, r)
        lo, hi = splits[r], splits[r + 1]
        errs, broken = pod_est_diff(case, one, p, lo, hi)
        if broken:
            bad.append(f"({tag}) rank {r} differs from the one-process fit "
                       f"in {broken}: {errs}")
        k = p["kernels"]
        if case == "gbmcv":
            want = sum(p["ntrees"]) * 6 * (POD_S // 2)
            if (k["hist"], k["hist_rows"]) != (want, 0):
                bad.append(f"({tag}) rank {r}: B1 {k['hist']}, B2 "
                           f"{k['hist_rows']}; expected {want}, 0")
        elif any(k.values()):
            bad.append(f"({tag}) rank {r} launched hand-written kernels: "
                       f"{k}")
        if case in ("glm", "kmpca") and p["path"] != "fused_mesh":
            bad.append(f"({tag}) rank {r}: path {p['path']}, not "
                       "fused_mesh")
        bad.extend(f"({tag}) rank {r}: {why}"
                   for why in _lane_faults(case, p.get("fits"), pod=True))
        g = p["gathers"]
        ranks.append(dict(
            rank=r, rows=hi - lo, wall_s=p["wall_s"], errors=errs,
            kernels=k, gathers=g["calls"], gathered_bytes=g["bytes"],
            gather_s=g["seconds"],
            **{key: p[key] for key in ("path", "pca_path", "iters",
                                       "warm_s", "km_iters", "km_wall_s",
                                       "init_gather_bytes",
                                       "demean_gather_bytes", "ntrees",
                                       "fit_timings", "lbfgs_steps",
                                       "func_evals", "irls_iterations",
                                       "fits") if key in p}))
    key = f"j_{case}" if tag == "j" else tag
    rec[key] = dict(ranks=2, case=case, launch_wall_s=wall,
                    one_process={key: one[key] for key in (
                        "wall_s", "path", "pca_path", "iters", "km_iters",
                        "ntrees", "kernels", "fit_timings", "lbfgs_steps",
                        "func_evals", "irls_iterations", "fits")
                        if key in one},
                    per_rank=ranks)
    print(f"phase 40({tag}) 2 ranks, {case}, on {card}: "
          + json.dumps(rec[key], default=str), flush=True)


def _lane_faults(case: str, fits, pod: bool) -> list:
    """What is wrong with the lanes (h)-(j)'s fits recorded: each fit's
    path, S = POD_S and its ranks (2 on the pod, 1 in one process)."""
    if not fits:
        return []
    want = POD_EST_PATHS.get(case, ("fused_blocks", "fused_mesh"))[int(pod)]
    return [f"{name}: plan {plan}, expected [{want!r}, {POD_S}, "
            f"{2 if pod else 1}]" for name, f in fits.items()
            for plan in [f["plan"]]
            if plan != [want, POD_S, 2 if pod else 1]]


def pod_path(dev, card):
    """Phase 40: (a) the 2-rank GBM and (b) the 2-rank DRF on B2 at config
    1's width, (c) four ranks with QuantilesGlobal, (d) NCCL where each
    rank has a card; each equal to the one-process blocks-lane fit at
    S = 8. (e)-(g) the estimator engine on (a)'s ranks: the Airlines GLM
    with p-values and 3 folds, K-Means and PCA, (a)'s GBM with 3 folds."""
    import shutil

    t_phase = time.perf_counter()
    bad, rec = [], dict(card=card, rows=POD_ROWS, rows_from=POD_ROWS_FROM,
                        S=POD_S)
    print(f"phase 40 cut: (a), (b) fit {POD_ROWS} of config 1's "
          f"{POD_ROWS_FROM} HIGGS rows, as phase 39; (c) {POD_QG_ROWS} of "
          f"them; (e) {POD_AIR_ROWS} of config 2's {AIR_ROWS} Airlines "
          f"rows; (f) {POD_COV_ROWS} of Covertype's {COV_ROWS}; (g) "
          f"{POD_CV_ROWS} of (a)'s rows; (h) (e)'s rows and "
          f"{POD_AIR_VALID} validation rows (phase 18's {AIR_VALID}); (i) "
          f"(f)'s rows; (j) K-Means on (f)'s rows, PCA and SVD on all "
          f"{DL_ROWS} MNIST-shaped rows, Power at nv {POD_POWER_NV} of "
          f"{UNSUP_PCA_K}", flush=True)
    tmp = tempfile.mkdtemp(prefix="h2o3_pod_")
    # (a)-(c) share one card over gloo, whatever the host shows
    one_card = dict(CUDA_VISIBLE_DEVICES=os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    # every rank starts now: its start and its frame overlap the
    # one-process fits below, and each waits for its go before it fits
    launches = [pod_start(2, ["gbm", "drf", *POD_EST_CASES], tmp, "ab",
                          one_card),
                pod_start(4, ["qg"], tmp, "c", one_card)]
    try:
        _pod_legs(dev, card, tmp, launches, bad, rec)
    finally:
        for launch in launches:
            pod_stop(launch)
        shutil.rmtree(tmp, ignore_errors=True)
    PHASE40_WALLS["phase_s"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError("phase 40: " + "; ".join(bad))
    return rec


def _pod_legs(dev, card, tmp, launches, bad, rec):
    """Phase 40's one-process fits, then each launch's go, join and legs
    (a)-(d). (a)'s launch goes before the one-process fits of (h)-(j),
    which then run beside its ranks' (a)-(g), and (c)'s after them, beside
    (a)'s last legs (the card shared by up to seven processes: the walls
    include that)."""
    from h2o3_tpu_torch.models import dataset_cache as dsc

    X, y = make_higgs_like(POD_ROWS)
    ones = {}
    env = dict(H2O3_TREE_OOC=0, H2O3_TREE_SHARD=1,
               H2O3_TREE_SHARD_BLOCKS=POD_S, H2O3_CV_REBIN=1,
               H2O3_EST_SHARD=1, H2O3_EST_SHARD_BLOCKS=POD_S)
    src = {"higgs": (X, y)}

    def one_est(cases):
        for case in cases:
            t0 = time.perf_counter()
            fr = pod_case_frame(case, 0, pod_splits(case, 1)[-1], src)
            PHASE40_WALLS[f"frame_{case}_s"] = time.perf_counter() - t0
            _, ones[case] = pod_fit(dev, case, fr)
            PHASE40_WALLS[f"one_{case}_s"] = time.perf_counter() - t0
            del fr

    with ooc_env(**env):
        # the GBM and the DRF share one frame (the DRF hits its bins), as
        # they do on the ranks
        fr = pod_frame(0, POD_ROWS, X, y)
        for case in ("gbm", "drf", "qg"):
            if case == "qg":
                fr = pod_frame(0, POD_QG_ROWS, X, y)
            t0 = time.perf_counter()
            _, ones[case] = pod_fit(dev, case, fr)
            PHASE40_WALLS[f"one_{case}_s"] = time.perf_counter() - t0
        del fr
        one_est(POD_EST_CASES[:3])
    pod_go(launches[0])
    with ooc_env(**env):
        one_est(POD_EST_CASES[3:])
    PHASE40_WALLS["one_after_go_s"] = time.perf_counter() - launches[0][
        "t_go"]
    # (c)'s ranks go now, beside (a)'s last legs
    pod_go(launches[1])
    del src, X, y
    dsc.clear()
    for case in POD_EST_CASES:
        k = ones[case]["kernels"]
        want = (dict(k, hist=sum(ones[case]["ntrees"]) * 6 * POD_S,
                     hist_rows=0) if case == "gbmcv"
                else {name: 0 for name in k})
        if k != want:
            bad.append(f"one-process {case}: kernels {k}, expected {want}")
        if case in ("glm", "kmpca") and ones[case]["path"] != "fused_blocks":
            bad.append(f"one-process {case}: path {ones[case]['path']}, "
                       "not fused_blocks")
        bad.extend(f"one-process {case}: {why}" for why in _lane_faults(
            case, ones[case].get("fits"), pod=False))
    half = POD_S // 2
    nt = {k: int(ones[k]["ntrees"]) for k in POD_CASES}
    for case, b1, b2 in (("gbm", nt["gbm"] * 6 * POD_S, 0),
                         ("drf", 0, nt["drf"] * 12 * POD_S),
                         ("qg", nt["qg"] * 6 * POD_S, 0)):
        if (ones[case]["b1"], ones[case]["b2"]) != (b1, b2):
            bad.append(f"one-process {case}: B1 {ones[case]['b1']}, B2 "
                       f"{ones[case]['b2']}; expected {b1}, {b2}")
    # (a) and (b) in one launch, sharing each rank's frame
    wall = PHASE40_WALLS["ab_launch_s"] = pod_join(launches[0])
    ranks_a = pod_leg(card, tmp, "a", "gbm", 2, ones["gbm"],
                      dict(b1=nt["gbm"] * 6 * half, b2=0), bad, rec,
                      wall)
    for r in ranks_a:
        if r["device_peak_bytes"] > 0.75 * ones["gbm"][
                "device_peak_bytes"]:
            bad.append(f"(a) rank {r['rank']}: device peak "
                       f"{r['device_peak_bytes']} over 0.75x the "
                       f"one-process fit's "
                       f"{ones['gbm']['device_peak_bytes']}")
    pod_leg(card, tmp, "b", "drf", 2, ones["drf"],
            dict(b1=0, b2=nt["drf"] * 12 * half), bad, rec, wall)
    for case in POD_EST_CASES:
        pod_est_leg(card, tmp, POD_EST_TAGS[case], case, ones[case], bad,
                    rec, wall)
    wall = PHASE40_WALLS["c_launch_s"] = pod_join(launches[1])
    pod_leg(card, tmp, "c", "qg", 4, ones["qg"],
            dict(b1=nt["qg"] * 6 * (POD_S // 4), b2=0), bad, rec, wall)
    if torch.cuda.device_count() >= 2:
        # one card a rank: the launcher picks NCCL
        launches.append(pod_start(2, ["gbm"], tmp, "d"))
        wall = PHASE40_WALLS["d_launch_s"] = pod_join(launches[-1])
        ranks_d = pod_leg(card, tmp, "d", "gbm", 2, ones["gbm"],
                          dict(b1=nt["gbm"] * 6 * half, b2=0), bad, rec,
                          wall)
        if any(r["backend"] != "nccl" for r in ranks_d):
            bad.append("(d) the ranks did not run over NCCL")
    else:
        print(f"phase 40(d) on {card}: one card visible "
              f"(torch.cuda.device_count() = "
              f"{torch.cuda.device_count()}); the NCCL leg did not run "
              "(the gloo legs ran the same fits on the card)", flush=True)


# -- phase 41: the GBM/DRF class and constraint parameters --------------------
#
# (a) phase 4's HIGGS GBM (1M x 28, depth 6, 20 trees, UniformAdaptive) with a
# +1 constraint on f0 and a -1 on f1 (the generator's logit rises with f0 and
# falls with f1); (b) the ULB credit-card shape (284,807 x 30, 492 positives)
# with its label drawn from a known logistic of four V columns: a balanced GBM
# with Platt scaling and one with isotonic regression; (c) a DRF with
# sample_rate_per_class=[0.1, 1.0] on the same frame; (d) (a)-(c) card
# against CPU at 20,000 rows.

MONO41 = {"f0": 1, "f1": -1}
MONO41_SWEEP_ROWS, MONO41_SWEEP_POINTS = 1_000, 64
# the label's logistic, per standard deviation of each column
CC41_BETA = {"V4": 1.1, "V10": -0.9, "V14": -1.3, "V17": -0.8}
CC41_SPLIT = (0.6, 0.2)            # train, calibration; the rest is holdout
CC41_GBM = dict(ntrees=20, max_depth=5, learn_rate=0.1, seed=41,
                balance_classes=True, calibrate_model=True)
CC41_DRF = dict(ntrees=20, seed=41, hist_method="pallas",
                sample_rate_per_class=[0.1, 1.0])
CC41_LOGLOSS_TOL = 0.01            # calibrated holdout logloss ≤ raw + this
# (c)'s floors, from tools/phase41_rehearsal.py on the CPU (a quarter of
# the rows, seeds 41-43: out-of-bag AUC 1.0 each, holdout 0.751-0.814). The
# positives' rate of 1.0 leaves them never out of bag, so their out-of-bag
# scores fall back to the in-bag forest and the out-of-bag AUC reads high
CC41_DRF_FLOORS = dict(oob_auc=0.95, holdout_auc=0.70)
P41_SMALL = 20_000                 # (d)'s rows
# (d)'s bars: predictions (and `cal_` columns) and the DRF's leaf values
# the CPU tests' 1e-5; the GBMs' leaf values the rows reach 1e-4, as phase
# 16's 4-class GBM: their node values and monotone bounds come from
# histogram sums, B1's fixed point on the card and f32 sums on the CPU
P41_SMALL_TOL, P41_GBM_LEAF_TOL = 1e-5, 1e-4
PHASE41_WALLS: dict = {}


def make_creditcard_labelled(seed: int, n: int = CC_ROWS,
                             positives: int = CC_FRAUD):
    """(X, y, p) of the ULB dataset's shape: `make_creditcard_like`'s
    columns without its planted offsets, and a label drawn from the
    logistic of CC41_BETA's columns (each over its standard deviation)
    plus an intercept, found by bisection on one draw of uniforms so that
    exactly `positives` rows are 1; p is the generator's probability."""
    rng = np.random.default_rng(seed)
    sd = np.linspace(1.96, 0.33, 28)
    X = np.empty((n, 30))
    X[:, 0] = np.sort(rng.uniform(0, CC_TIME_S, n))
    X[:, 1:29] = rng.standard_normal((n, 28)) * sd
    X[:, 29] = np.round(rng.lognormal(3.1, 1.65, n), 2)
    s = sum(b * X[:, CC_NAMES.index(c)] / sd[CC_NAMES.index(c) - 1]
            for c, b in CC41_BETA.items())
    u = rng.random(n)
    lo, hi = -40.0, 10.0
    for _ in range(200):
        b0 = 0.5 * (lo + hi)
        k = int((u < 1 / (1 + np.exp(-(b0 + s)))).sum())
        if k == positives:
            break
        lo, hi = (b0, hi) if k < positives else (lo, b0)
    else:
        raise AssertionError("no intercept gives the positives asked for")
    p = 1 / (1 + np.exp(-(b0 + s)))
    return X, (u < p).astype(np.float64), p


def creditcard_frames(seed: int = 41):
    """The labelled credit-card frame split train / calibration / holdout
    (CC41_SPLIT, a seeded permutation, each part in row order): returns
    the three frames and, per part, (y, generator probability)."""
    from h2o3_tpu_torch.frame.frame import Frame

    X, y, p = make_creditcard_labelled(seed)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=CC_NAMES + ["Class"]).asfactor("Class")
    n = len(y)
    perm = np.random.default_rng(seed + 1).permutation(n)
    a, b = int(CC41_SPLIT[0] * n), int((CC41_SPLIT[0] + CC41_SPLIT[1]) * n)
    parts = [np.sort(perm[:a]), np.sort(perm[a:b]), np.sort(perm[b:])]
    return ([fr.take(i) for i in parts], [(y[i], p[i]) for i in parts])


def _logloss(y, p) -> float:
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(np.where(y > 0.5, np.log(p), np.log(1 - p))))


def _reset_counts():
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    hist_cuda.launches = hist_cuda.launches_rows = score_cuda.launches = 0
    score_cuda.launches_resident = score_cuda.launches_streamed = 0
    histogram.DISPATCH.clear()
    torch.cuda.synchronize()


def _read_counts() -> dict:
    from h2o3_tpu_torch.ops import hist_cuda, histogram, score_cuda

    torch.cuda.synchronize()
    return dict(b1=hist_cuda.launches, b2=hist_cuda.launches_rows,
                score=score_cuda.launches,
                dispatch=dict(histogram.DISPATCH))


def sweep_violations(model, X: np.ndarray, col: int, sign: int,
                     points: int) -> int:
    """Rows whose prediction moves against `sign` along a sweep of column
    `col` over its range, the row's other columns held."""
    from h2o3_tpu_torch.frame.frame import Frame

    grid = np.linspace(X[:, col].min(), X[:, col].max(), points)
    rows = np.repeat(X, points, axis=0)
    rows[:, col] = np.tile(grid, X.shape[0])
    p = np.asarray(model.predict(Frame.from_numpy(rows, names=model.x))
                   .vec("1").data, np.float64)
    return int((sign * np.diff(p.reshape(X.shape[0], points), axis=1)
                < 0).sum())


def monotone_higgs_path(dev, card, phase4_holdout_auc: float):
    """Phase 41(a): the monotone HIGGS GBM, B1 its only route."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.models.tree import monotone_violations

    t0 = time.perf_counter()
    X, y = make_higgs_like(N_ROWS)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    del X
    Xt, yt = make_higgs_like(100_000, seed=1)
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    PHASE41_WALLS["a_frames_s"] = time.perf_counter() - t0
    gbm = H2OGradientBoostingEstimator(
        ntrees=NTREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42,
        monotone_constraints=MONO41, device=str(dev))
    _reset_counts()
    t0 = time.perf_counter()
    gbm.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit = _read_counts()
    del fr
    model = gbm.model
    mono = [float(MONO41.get(n, 0)) for n in model.x]
    p1 = np.asarray(model.predict(ft).vec("1").data, np.float64)
    sweep = {c: sweep_violations(model, Xt[:MONO41_SWEEP_ROWS],
                                 model.x.index(c), s, MONO41_SWEEP_POINTS)
             for c, s in MONO41.items()}
    after = _read_counts()
    rec = dict(card=card, rows=N_ROWS, wall_s=wall,
               trees_per_s=NTREES / wall, fit_timings=model.fit_timings,
               holdout_auc=auc_exact(yt, p1),
               phase4_holdout_auc=phase4_holdout_auc,
               bound_violations=monotone_violations(model.forest[0], mono),
               sweep_violations=sweep, compact_cap=model.compact_cap,
               b1_launches=fit["b1"], b2_launches=fit["b2"],
               dispatch=fit["dispatch"], score_launches=after["score"])
    PHASE41_WALLS["a_s"] = time.perf_counter() - t0
    print(f"phase 41(a) monotone HIGGS GBM on {card}: " + json.dumps(rec),
          flush=True)
    bad = []
    expect = NTREES * DEPTH
    if fit["b1"] != expect or fit["b2"] or fit["dispatch"] != {
            "pallas_factored": expect}:
        bad.append(f"dispatch {fit}, expected {expect} B1 passes only")
    if rec["bound_violations"] or any(sweep.values()):
        bad.append(f"monotonicity violated: {rec['bound_violations']} "
                   f"splits, sweep {sweep}")
    if rec["holdout_auc"] < 0.75:
        bad.append(f"holdout AUC {rec['holdout_auc']} < 0.75")
    if after["score"] != 3:
        bad.append(f"{after['score']} forest launches for 3 predicts")
    if bad:
        raise AssertionError("phase 41(a): " + "; ".join(bad))
    return rec


def _served_equal(dev, model, frame, key: str) -> dict:
    """The engine's batch and a forced failover batch of `frame`, each
    against `predict`: the largest difference over every probability and
    `cal_` column, and the failover's scorer kind."""
    from h2o3_tpu_torch.runtime import faults
    from h2o3_tpu_torch.serving import ScoringEngine
    from h2o3_tpu_torch.serving.config import ServingConfig

    want = model.predict(frame)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0, breaker_reset_s=30.0))
    outs = {"served": eng.score(key, model, frame)}
    faults.arm("serving.scorer", error="device", rate=1.0)
    try:
        outs["failover"] = eng.score(key, model, frame)
        snap = eng.snapshot()
    finally:
        faults.reset()
        eng.shutdown()
    rec = dict(fallback_scores=snap["totals"]["fallback_scores"])
    for tag, out in outs.items():
        same = (out.names == want.names and list(out.vec("predict").to_numpy())
                == list(want.vec("predict").to_numpy()))
        rec[f"{tag}_max_diff"] = (max(float(np.abs(
            np.asarray(out.vec(c).data, np.float64)
            - np.asarray(want.vec(c).data, np.float64)).max())
            for c in want.names[1:]) if same else float("inf"))
    return rec


def _host_newton(p1: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Platt's (a, b) by Newton on the host in f64, written out: the
    2 × 2 system inverted by hand, 50 steps."""
    z = np.log(np.clip(p1, 1e-12, 1 - 1e-12) / np.clip(1 - p1, 1e-12, 1 - 1e-12))
    a = b = 0.0
    for _ in range(50):
        mu = 1 / (1 + np.exp(-(a * z + b)))
        wd = np.clip(mu * (1 - mu), 1e-10, None)
        ga, gb = float(z @ (y - mu)), float((y - mu).sum())
        haa, hab, hbb = float((wd * z) @ z), float(wd @ z), float(wd.sum())
        det = haa * hbb - hab * hab
        a, b = a + (hbb * ga - hab * gb) / det, b + (haa * gb - hab * ga) / det
    return np.asarray([a, b])


def creditcard_gbm_path(dev, card, frames, labels):
    """Phase 41(b): a balanced GBM with Platt scaling, then one with
    isotonic regression, on the labelled credit-card frame."""
    from h2o3_tpu_torch import mojo
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.models import shared_tree
    from h2o3_tpu_torch.models.isotonic import pav

    tr, cal, ho = frames
    (y_tr, _), (y_cal, _), (y_ho, _) = labels
    counts = np.bincount(y_tr.astype(np.int64), minlength=2).astype(np.float64)
    n = float(len(y_tr))
    factors = np.minimum(n / (2 * counts), 5.0 * n / counts)
    w_host = (np.ones(len(y_tr), np.float32)
              * factors[y_tr.astype(np.int64)]).astype(np.float32)
    prior, modeld = counts / n, counts * factors / (counts * factors).sum()
    bad, out = [], {}
    for method in ("PlattScaling", "IsotonicRegression"):
        t0 = time.perf_counter()
        seen = []
        real = shared_tree.dist_mod.init_margin

        def rec_w(dist, yv, w, **kw):
            seen.append(np.array(w))
            return real(dist, yv, w, **kw)

        est = H2OGradientBoostingEstimator(
            calibration_frame=cal, calibration_method=method,
            device=str(dev), **CC41_GBM)
        _reset_counts()
        with mock.patch.object(shared_tree.dist_mod, "init_margin", rec_w):
            est.train(y="Class", training_frame=tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit = _read_counts()
        m = est.model
        Xh = m._matrix(ho)
        raw = shared_tree.probs_from_margins("gbm", "binomial", "bernoulli",
                                             m._margins(Xh), m.ntrees_built)
        q = raw * (prior / modeld)[None, :]
        q = q / q.sum(axis=1, keepdims=True)
        corr_err = float(np.abs(m._score_probs(Xh) - q).max())
        p_cal = m._score_probs(m._matrix(cal))[:, 1]
        r = dict(card=card, method=method, rows=tr.nrow, wall_s=wall,
                 trees_per_s=CC41_GBM["ntrees"] / wall,
                 weights_equal=bool(len(seen) == 1 and np.array_equal(
                     seen[0], w_host)),
                 correction_max_err=corr_err, b1_launches=fit["b1"],
                 dispatch=fit["dispatch"])
        if method == "PlattScaling":
            host = _host_newton(p_cal, y_cal)
            r["platt_ab"] = [m.calibrator.a, m.calibrator.b]
            r["platt_max_err"] = float(np.abs(
                np.asarray(r["platt_ab"]) - host).max())
            ok_cal = r["platt_max_err"] <= 1e-10
        else:
            tx, ty = pav(p_cal, y_cal, np.ones_like(y_cal))
            r["knots"] = len(tx)
            ok_cal = (np.array_equal(tx, m.calibrator.knots_x)
                      and np.array_equal(ty, m.calibrator.knots_y))
            r["knots_equal"] = ok_cal
        pred = m.predict(ho)
        p_raw = np.asarray(pred.vec("1").data, np.float64)
        p_c = np.asarray(pred.vec("cal_1").data, np.float64)
        r["holdout_logloss_raw"] = _logloss(y_ho, p_raw)
        r["holdout_logloss_calibrated"] = _logloss(y_ho, p_c)
        r.update(_served_equal(dev, m, ho.take(np.arange(2_000)),
                               f"cc_{method}"))
        with tempfile.TemporaryDirectory() as d:
            sc = mojo.load_model(mojo.save_model(m, d, "cc.h2o3"))
            p_mojo = np.asarray(sc.predict(ho).vec("1").data, np.float64)
        r["mojo_gap"] = float(np.abs(p_mojo - p_raw).max())
        PHASE41_WALLS[f"b_{method}_s"] = time.perf_counter() - t0
        print(f"phase 41(b) balanced GBM, {method}, on {card}: "
              + json.dumps(r), flush=True)
        out[method] = r
        expect = CC41_GBM["ntrees"] * CC41_GBM["max_depth"]
        if not r["weights_equal"] or corr_err > 1e-12 or not ok_cal:
            bad.append(f"{method}: weights, correction or calibrator off "
                       "their host recounts")
        if fit["b1"] != expect or fit["dispatch"] != {"pallas_factored": expect}:
            bad.append(f"{method}: dispatch {fit}, expected {expect} B1")
        if r["holdout_logloss_calibrated"] > (r["holdout_logloss_raw"]
                                              + CC41_LOGLOSS_TOL):
            bad.append(f"{method}: calibrated logloss "
                       f"{r['holdout_logloss_calibrated']} above raw "
                       f"{r['holdout_logloss_raw']} + {CC41_LOGLOSS_TOL}")
        if max(r["served_max_diff"], r["failover_max_diff"]) > 1e-6 \
                or r["fallback_scores"] < 1:
            bad.append(f"{method}: served {r['served_max_diff']}, failover "
                       f"{r['failover_max_diff']} from predict")
    if bad:
        raise AssertionError("phase 41(b): " + "; ".join(bad))
    return out


def creditcard_drf_path(dev, card, frames, labels):
    """Phase 41(c): the DRF with per-class rates; B2 the plan's passes."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.models import shared_tree
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.models.tree import histogram_level_plan

    tr, _, ho = frames
    (y_tr, p_tr), _, (y_ho, p_ho) = labels
    seen = []
    real = shared_tree.class_row_rates

    def rec_rates(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.copy())
        return out

    t0 = time.perf_counter()
    est = H2ORandomForestEstimator(device=str(dev), **CC41_DRF)
    _reset_counts()
    with mock.patch.object(shared_tree, "class_row_rates", rec_rates):
        est.train(y="Class", training_frame=tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit = _read_counts()
    m = est.model
    plan = (CC41_DRF["ntrees"] * len(histogram_level_plan(m.max_depth,
                                                           m.compact_cap))
            + m.dense_rebuilds * len(histogram_level_plan(m.max_depth)))
    want = np.asarray(CC41_DRF["sample_rate_per_class"],
                      np.float32)[y_tr.astype(np.int64)]
    p1 = np.asarray(m.predict(ho).vec("1").data, np.float64)
    rec = dict(card=card, rows=tr.nrow, wall_s=wall,
               trees_per_s=CC41_DRF["ntrees"] / wall,
               max_depth=m.max_depth, dense_rebuilds=m.dense_rebuilds,
               rates_equal=bool(len(seen) == 1
                                and np.array_equal(seen[0], want)),
               b2_launches=fit["b2"], planned_passes=plan,
               b1_launches=fit["b1"], dispatch=fit["dispatch"],
               oob_auc=float(m.training_metrics.auc),
               generator_train_auc=auc_exact(y_tr, p_tr),
               holdout_auc=auc_exact(y_ho, np.round(p1, 6)),
               generator_holdout_auc=auc_exact(y_ho, p_ho))
    PHASE41_WALLS["c_s"] = time.perf_counter() - t0
    print(f"phase 41(c) DRF with per-class rates on {card}: "
          + json.dumps(rec), flush=True)
    bad = []
    if not rec["rates_equal"]:
        bad.append("the fit's row rates are not rates[y]")
    if fit["b2"] != plan or fit["b1"] or fit["dispatch"] != {"pallas": plan}:
        bad.append(f"dispatch {fit}, expected {plan} B2 passes only")
    if any(rec[k] < v for k, v in CC41_DRF_FLOORS.items()):
        bad.append(f"AUCs {rec['oob_auc']} (OOB), {rec['holdout_auc']} "
                   f"(holdout) under the floors {CC41_DRF_FLOORS}")
    if bad:
        raise AssertionError("phase 41(c): " + "; ".join(bad))
    return rec


def tree_params_small_checks(dev, card, frames):
    """Phase 41(d): (a)-(c) at P41_SMALL rows, card against CPU: the
    forests node for node, every row in the same leaf of every tree, the
    leaf values it reaches within P41_GBM_LEAF_TOL (the DRF's 0/1 sums are
    exact: within P41_SMALL_TOL) and predictions (`cal_` columns
    included) within P41_SMALL_TOL."""
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(P41_SMALL, seed=41)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    fh = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    tr, cal, _ = frames
    small, small_cal = tr.take(np.arange(P41_SMALL)), cal.take(np.arange(5_000))
    cases = (
        ("monotone_gbm", H2OGradientBoostingEstimator, fh, "label",
         dict(ntrees=5, max_depth=DEPTH, histogram_type="UniformAdaptive",
              seed=42, monotone_constraints=MONO41)),
        ("balanced_platt_gbm", H2OGradientBoostingEstimator, small, "Class",
         dict(CC41_GBM, ntrees=5, calibration_frame=small_cal)),
        # a set depth: the memory clamp of the default 20 differs between
        # the card (19) and the CPU (17)
        ("rates_drf", H2ORandomForestEstimator, small, "Class",
         dict(CC41_DRF, ntrees=5, max_depth=12)))
    bad, out = [], {}
    for name, cls, frame, y_name, params in cases:
        a = _pair_fit(cls, str(dev), params, frame, y=y_name)
        b = _pair_fit(cls, "cpu", params, frame, y=y_name)
        nodes, dv = _forest_diff(a, b)
        check = small_cal if name == "balanced_platt_gbm" else frame
        rows, dleaf = _leaves_diff(a, b, check)
        pa, pb = a.predict(check), b.predict(check)
        dp = max(float(np.abs(np.asarray(pa.vec(c).data, np.float64)
                              - np.asarray(pb.vec(c).data, np.float64)).max())
                 for c in pa.names[1:]) if pa.names == pb.names else float("inf")
        out[name] = dict(card=card, rows=frame.nrow, differing_nodes=nodes,
                         max_node_value_diff=dv, rows_in_other_leaves=rows,
                         max_leaf_value_diff=dleaf, max_predict_diff=dp,
                         columns=pa.names)
        print(f"phase 41(d) {name} card vs cpu: {json.dumps(out[name])}",
              flush=True)
        leaf_tol = P41_SMALL_TOL if name == "rates_drf" else P41_GBM_LEAF_TOL
        if nodes or rows or dleaf > leaf_tol or dp > P41_SMALL_TOL \
                or (name == "rates_drf" and dv > P41_SMALL_TOL):
            bad.append(f"{name}: {out[name]}")
    if bad:
        raise AssertionError("phase 41(d): card and CPU differ: "
                             + "; ".join(bad))
    return out


def tree_params_path(dev, card, phase4_holdout_auc: float):
    """Phase 41: (a)-(d) in turn; returns the phase's record."""
    from h2o3_tpu_torch.models import dataset_cache as dsc

    t_phase = time.perf_counter()
    rec_a = monotone_higgs_path(dev, card, phase4_holdout_auc)
    dsc.clear()
    t0 = time.perf_counter()
    frames, labels = creditcard_frames()
    PHASE41_WALLS["b_frames_s"] = time.perf_counter() - t0
    rec_b = creditcard_gbm_path(dev, card, frames, labels)
    rec_c = creditcard_drf_path(dev, card, frames, labels)
    t0 = time.perf_counter()
    rec_d = tree_params_small_checks(dev, card, frames)
    PHASE41_WALLS["d_s"] = time.perf_counter() - t0
    dsc.clear()
    PHASE41_WALLS["phase_s"] = time.perf_counter() - t_phase
    return dict(a=rec_a, b=rec_b, c=rec_c, d=rec_d)


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

    def at(label):
        """The smoke's elapsed wall after each step of main."""
        print(f"[smoke at {time.time() - t0:.1f} s] after {label}", flush=True)

    rows, worst = kernel_vs_plain(dev)
    at("kernel_vs_plain")
    rec, fr, gbm_model = main_path(dev)
    at("main_path")
    small_reference_check(dev)
    at("small_reference_check")
    profile_fit(H2OGradientBoostingEstimator(
        ntrees=PROFILE_TREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42, device=str(dev)), fr)
    rows_b2, worst_b2 = rows_vs_plain(dev)
    at("rows_vs_plain")
    drf_rec, drf_model = drf_path(dev, fr)
    at("drf_path")
    small_drf_check(dev)
    at("small_drf_check")
    profile_fit(H2ORandomForestEstimator(
        ntrees=DRF_PROFILE_TREES, hist_method="pallas", seed=42,
        device=str(dev)), fr, tag="drf profile")
    del fr
    rows_sc, worst_sc = score_vs_plain(dev, {
        "gbm": (gbm_model.forest[0], gbm_model.max_depth),
        "drf": (drf_model.forest[0], drf_model.max_depth)})
    serve_rec = serve_path(dev, gbm_model)
    at("serve_path")
    mojo_round_trip(dev, {"gbm": gbm_model, "drf": drf_model})
    at("mojo_round_trip")
    # phases 20-23 explain phase 4's and phase 8's models while they live
    _, shap_entry = contributions_path(dev, gbm_model, drf_model)
    at("contributions_path")
    leaves_path(dev, gbm_model, drf_model)
    at("leaves_path")
    serve_explanations(dev, gbm_model)
    at("serve_explanations")
    small_explain_checks(dev)
    at("small_explain_checks")
    del gbm_model, drf_model
    fr_cov, fv_cov = covtype_frames()
    multinomial_gbm_path(dev, fr_cov, fv_cov)
    at("multinomial_gbm_path")
    profile_fit(H2OGradientBoostingEstimator(
        device=str(dev), **dict(COV_GBM, ntrees=COV_PROFILE_TREES)),
        fr_cov, tag="multinomial gbm profile", y="cover", valid=fv_cov)
    torch.cuda.reset_peak_memory_stats(dev)
    multinomial_drf_path(dev, fr_cov, fv_cov)
    at("multinomial_drf_path")
    # phase 30: the multinomial GLM, on the same frames
    multinomial_glm_path(dev, fr_cov, fv_cov)
    at("multinomial_glm_path")
    del fr_cov, fv_cov
    small_multinomial_glm_checks(dev, card_line())
    at("small_multinomial_glm_checks")
    small_extension_checks(dev)
    at("small_extension_checks")
    fr_air, p_air, y_air = make_airlines_like(AIR_ROWS, 0)
    glm_rec = airlines_glm_path(dev, fr_air, p_air, y_air)
    at("airlines_glm_path")
    fv_air, _, _ = make_airlines_like(AIR_VALID, 2)
    airlines_lambda_path(dev, fr_air, fv_air)
    at("airlines_lambda_path")
    # phase 31(d): gblinear on the same frame
    xgb_gblinear_path(dev, fr_air, glm_rec, card_line())
    at("xgb_gblinear_path")
    del fr_air, fv_air
    small_glm_checks(dev)
    at("small_glm_checks")
    # phases 24-28: cross-validation and the stacked ensemble on phase 4's
    # frame, made again from its seed
    card = card_line()
    X, y = make_higgs_like(N_ROWS)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=[
        f"f{i}" for i in range(N_FEAT)] + ["label"]).asfactor("label")
    del X
    _, cv_ests = cv_tree_path(dev, fr, y, card)
    at("cv_tree_path")
    cv_glm_and_ensemble(dev, fr, cv_ests, card)
    at("cv_glm_and_ensemble")
    del cv_ests
    # phase 31(b), (c) and (e): XGBoost on the same frame
    xgb_rec, _, b256 = xgb_automl_path(dev, fr, card)
    at("xgb_automl_path")
    xgb_dart_path(dev, fr, card)
    at("xgb_dart_path")
    del fr
    small_cv_checks(dev, card)
    at("small_cv_checks")
    # phase 29: 16-bit codes, on benchm-ml's Airlines GBM
    bm_recs, bm_codes, bm_passes = airlines_bm_path(dev, card)
    at("airlines_bm_path")
    b16 = wide_kernels(dev, bm_codes, bm_passes)
    at("wide_kernels")
    del bm_codes
    small_bm_checks(dev, card)
    at("small_bm_checks")
    # phase 31(a) and (f): lambdarank at MSLR-WEB30K's shape, card vs CPU
    xgb_rank_path(dev, card)
    at("xgb_rank_path")
    xgb_small_checks(dev, card)
    at("xgb_small_checks")
    print("phase 31 wall: " + json.dumps(dict(
        PHASE31_WALLS, total_s=sum(PHASE31_WALLS.values()))), flush=True)
    # phase 32: DeepLearning on an MNIST-shaped frame, then card vs CPU
    dl_mnist_path(dev, card)
    at("dl_mnist_path")
    dl_small_checks(dev, card)
    at("dl_small_checks")
    print(f"phase 32 wall on {card}: " + json.dumps(dict(
        PHASE32_WALLS, total_s=sum(PHASE32_WALLS.values()))), flush=True)
    # phase 33: AutoML and grid search (config 5), then card vs CPU; 33(b)'s
    # CPU run starts now, in a child process beside 33(a)
    automl_cpu_start()
    at("automl_cpu_start")
    automl_path(dev, card)
    at("automl_path")
    automl_small_checks(dev, card)
    at("automl_small_checks")
    print(f"phase 33 wall on {card}: " + json.dumps(dict(
        PHASE33_WALLS, total_s=sum(PHASE33_WALLS.values()))), flush=True)
    # phase 34: K-Means, PCA, SVD and GLRM at full width, then card vs CPU
    unsupervised_path(dev, card)
    at("unsupervised_path")
    print(f"phase 34 wall on {card}: " + json.dumps(dict(
        PHASE34_WALLS, total_s=sum(PHASE34_WALLS.values()))), flush=True)
    # phase 35: the isolation forests and the uplift DRF at full width,
    # then card vs CPU
    _, uplift_entry = anomaly_uplift_path(dev, card)
    at("anomaly_uplift_path")
    print(f"phase 35 wall on {card}: " + json.dumps(dict(
        PHASE35_WALLS, total_s=sum(PHASE35_WALLS.values()))), flush=True)
    # phase 36: NaiveBayes, GAM, isotonic regression, ANOVA GLM and
    # ModelSelection at full width, then card vs CPU
    glm_family_path(dev, card)
    at("glm_family_path")
    print(f"phase 36 wall on {card}: " + json.dumps(dict(
        PHASE36_WALLS, total_s=sum(PHASE36_WALLS.values()))), flush=True)
    # phase 37: CoxPH, PSVM and RuleFit at full width, then card vs CPU
    survival_path(dev, card)
    at("survival_path")
    print(f"phase 37 wall on {card}: " + json.dumps(dict(
        PHASE37_WALLS, total_s=sum(PHASE37_WALLS.values()))), flush=True)
    # phase 38: TargetEncoder, Word2Vec, Aggregator, the quantiles op and
    # XGBoost's lossguide growth at full width, then card vs CPU
    _, lossguide_entry = item10_path(
        dev, card, xgb_rec["xgboost_1"]["holdout_auc"])
    at("item10_path")
    print(f"phase 38 wall on {card}: " + json.dumps(dict(
        PHASE38_WALLS, total_s=sum(PHASE38_WALLS.values()))), flush=True)
    # phase 39: the dataset cache and the out-of-core tree path, then card
    # vs CPU and the kernels at the streamed block shapes
    stream_entries = ooc_path(dev, card)
    at("ooc_path")
    print(f"phase 39 wall on {card}: " + json.dumps(PHASE39_WALLS),
          flush=True)
    # phase 40: the multi-process tree lane, ranks on the card through the
    # launcher, each held against a one-process blocks-lane fit
    pod_path(dev, card)
    at("pod_path")
    print(f"phase 40 wall on {card}: " + json.dumps(PHASE40_WALLS),
          flush=True)
    # phase 41: monotone constraints, class balancing with calibration and
    # per-class rates on the GBM/DRF path, then card vs CPU
    tree_params_path(dev, card, rec["holdout_auc"])
    at("tree_params_path")
    print(f"phase 41 wall on {card}: " + json.dumps(PHASE41_WALLS),
          flush=True)
    print(f"smoke wall on {card}: {time.time() - t0:.1f} s (kernel build "
          "included)", flush=True)

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
    # B1 over one uplift tree's 22 passes: phase 35(c)
    kernels.append(uplift_entry)
    # B1 over one lossguide tree's passes: phase 38(e)
    kernels.append(lossguide_entry)
    # B1 and B2 over one streamed block: phase 39(a) and (e)
    kernels.extend(stream_entries)
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
          f"hist_factored_uplift is tree 0 of phase 35(c)'s UpliftDRF, its "
          f"22 passes (L = 1 ... 1024, treatment and control; N={UP_ROWS}, "
          f"F={len(UP_NAMES)}, B={UP_NBINS}, L2 flushed), its launches that "
          "fit's; "
          f"hist_factored_lossguide is tree 0 of phase 38(e)'s lossguide "
          f"XGBoost, its passes as they ran (each L = 1 over N={N_ROWS} rows, "
          f"most weights zero; F={N_FEAT}, B={XGB_NBINS}, L2 flushed), its "
          "launches that fit's; "
          f"hist_factored_stream is one block of phase 39(a)'s streamed GBM "
          f"(its six passes, N = {OOC_ROWS} / S rows, F={N_FEAT}, B={NBINS}, "
          "the block's own codes, L2 flushed), its launches that fit's; "
          f"hist_rows_stream is one block of phase 39(e)'s streamed DRF (its "
          f"{OOC_DRF['max_depth']} passes, N = {OOC_SMALL} / S rows, "
          "row-major, L2 flushed), its launches that fit's; "
          "max_abs_err is against the f32 plain version (hist_factored also "
          "equals its fixed-point twin bit for bit)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-rank"]:
        sys.exit(pod_rank_main(sys.argv[2:]))
    sys.exit(main())
