"""H2ODeepLearningEstimator — multilayer perceptron, single device.

Port of the single-device path of `h2o3_tpu/models/deeplearning.py`
(reference parity: `hex/deeplearning/DeepLearning.java`, `Neurons.java`,
`DeepLearningModelInfo.java` and `h2o-py/h2o/estimators/deeplearning.py`).
As in the reference, H2O's Hogwild per-row updates are replaced by
synchronous minibatch SGD: every chunk of steps up to the next scoring
event draws one permutation of the rows and walks it in batches of
`mini_batch_size`.

Shape on the card: the design matrix is built on the device from compact
columns (`estimator_engine.design_matrix`, the reference's default dataset
cache path) and stays there. One f32 vector holds every W and b in the
reference's order; each step gathers its batch rows, takes the gradient of
the loss through views of that vector (`torch.autograd.grad`) and updates
it with ADADELTA or annealed-momentum SGD in a handful of full-vector ops.
The reference compiles a chunk into one `lax.scan`; the port runs the
steps eagerly, and the host reads the device only at scoring events.

Every draw is the reference's, bit for bit (`ops.prng`): the initial
weights, each chunk's permutation and each step's dropout masks, with the
keys split in the reference's order. Activations are Rectifier, Tanh and
Maxout (pairs of units, the max over each pair), each optionally
WithDropout; problems are binomial, multinomial, regression (gaussian or
poisson) and the autoencoder.

A `max_runtime_secs` budget takes the reference's per-batch path instead:
the design of `DataInfo.fit_transform` (standardized on the host in f64),
one step at a time on `mini_batch_size` rows drawn with numpy, and the
wall-clock check after every step. The fit checks its job for
cancellation before each chunk or step, as the reference does.

Not ported: the multi-device and multi-process lanes (ROADMAP queue A,
item 9) and checkpoints (item 5). The parameters the reference accepts
but never reads raise `NotImplementedError` at any value other than their
default (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..ops import prng
from . import estimator_engine as _est
from .metrics import (ModelMetricsBinomial, ModelMetricsMultinomial,
                      ModelMetricsRegression)
from .model_base import (DataInfo, H2OEstimator, H2OModel, ScoreKeeper,
                         ScoringHistory, _sync, check_unread, response_info)

ACTIVATIONS = (
    "Rectifier", "Tanh", "Maxout",
    "RectifierWithDropout", "TanhWithDropout", "MaxoutWithDropout",
)
_ITEM10 = "ROADMAP queue A, item 10: DeepLearning"

# accepted by the reference's estimator and never read by its fit: each
# raises at a value other than this default (ROADMAP §C)
_UNREAD = dict(
    rate_decay=1.0,
    nesterov_accelerated_gradient=True,
    initial_weight_distribution="UniformAdaptive",
    initial_weight_scale=1.0,
    loss="Automatic",
    score_interval=5.0,
    score_training_samples=10000,
    score_validation_samples=0,
    overwrite_with_best_model=True,
    shuffle_training_data=False,
    reproducible=False,
    variable_importances=True,
    export_weights_and_biases=False,
    elastic_averaging=False,
    stopping_metric="AUTO",
    offset_column=None,
)

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _dropout(h: torch.Tensor, key, ratio: float) -> torch.Tensor:
    """Keep each unit with probability 1 − ratio (the reference's
    `bernoulli(key, 1 - ratio, h.shape)`) and scale the kept ones."""
    keep = prng.bernoulli(key, 1 - ratio, tuple(h.shape), h.device)
    return torch.where(keep, h / (1 - ratio), 0.0)


def _act(name: str, x: torch.Tensor, key=None,
         dropout: float = 0.0) -> torch.Tensor:
    base = name.replace("WithDropout", "")
    if base == "Rectifier":
        h = torch.relu(x)
    elif base == "Tanh":
        h = torch.tanh(x)
    elif base == "Maxout":
        # Neurons.Maxout: pairs of units, the max over the pair. `amax`
        # splits the gradient among tied entries, as jnp.max's does
        h = x.reshape(x.shape[0], -1, 2).amax(dim=2)
    else:
        raise ValueError(f"unknown activation {name}")
    if dropout > 0.0 and key is not None:
        h = _dropout(h, key, dropout)
    return h


def _init_params(key, sizes: List[int], activation: str,
                 device=None) -> Params:
    """DeepLearningModelInfo.randomizeWeights — uniform-adaptive init:
    W ~ U(−l, l) with the f32 l = sqrt(6 / (fan_in + out_dim)), b = 0; a
    Maxout hidden layer has twice the units."""
    dev = devlib.resolve(device)
    params = []
    maxout = activation.startswith("Maxout")
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        hidden = i < len(sizes) - 2
        out_dim = fan_out * 2 if (maxout and hidden) else fan_out
        key, sub = prng.split(key)
        limit = float(np.sqrt(np.float32(6.0 / (fan_in + out_dim))))
        W = prng.uniform(sub, (fan_in, out_dim), dev, -limit, limit)
        b = torch.zeros(out_dim, dtype=torch.float32, device=dev)
        params.append((W, b))
    return params


def _forward(params: Params, X: torch.Tensor, activation: str,
             hidden_dropout, input_dropout: float, key,
             train: bool) -> torch.Tensor:
    """The network's output layer (linear: the link is applied by the loss
    or the scorer). Keys split in the reference's order: the input dropout
    first, then each hidden layer whose ratio is above 0."""
    h = X
    if train and input_dropout > 0:
        key, sub = prng.split(key)
        h = _dropout(h, sub, input_dropout)
    L = len(params)
    for i, (W, b) in enumerate(params):
        z = torch.addmm(b, h, W)
        if i < L - 1:
            dr = hidden_dropout[i] if train and hidden_dropout else 0.0
            if train and dr > 0:
                key, sub = prng.split(key)
            else:
                sub = None
            h = _act(activation, z, sub, dr if train else 0.0)
        else:
            h = z
    return h


class DeepLearningModel(H2OModel):
    algo = "deeplearning"

    def __init__(self, params_est, x, y, dinfo, problem, nclass, domain,
                 net_params: Params, activation, distribution, device=None):
        super().__init__(params_est)
        self.x = list(x)
        self.y = y
        self.dinfo = dinfo
        self.problem = problem
        self.nclass = nclass
        self.domain = domain
        self.net_params = net_params
        self.activation = activation
        self.distribution = distribution
        self.device = devlib.resolve(device)

    def _design(self, frame: Frame) -> torch.Tensor:
        return self.dinfo.device_design(frame, fit=False, device=self.device)

    def _output(self, frame: Frame, X_pre=None) -> torch.Tensor:
        """Scores on the device: probabilities, the mean (exp of the output
        for poisson), or the autoencoder's reconstruction. `X_pre` is the
        fit's design matrix, which the training loop passes so scoring
        events skip the expansion."""
        X = X_pre if X_pre is not None else self._design(frame)
        out = _forward(self.net_params, X, self.activation, None, 0.0, None,
                       False)
        if self.problem == "autoencoder":
            return out
        if self.problem in ("binomial", "multinomial"):
            return torch.softmax(out, dim=1)
        if self.distribution in ("poisson", "gamma", "tweedie"):
            return torch.exp(out[:, :1])
        return out[:, :1]

    def _score(self, frame: Frame, X_pre=None) -> np.ndarray:
        return self._output(frame, X_pre).cpu().numpy().astype(np.float64)

    def anomaly(self, frame: Frame) -> Frame:
        """Per-row reconstruction MSE (`h2o.anomaly` on an autoencoder), in
        f64 on the device."""
        if self.problem != "autoencoder":
            raise ValueError("anomaly() requires autoencoder=True")
        X = self._design(frame)   # one expansion, reused for both
        rec = self._output(frame, X)
        mse = ((rec.double() - X.double()) ** 2).mean(dim=1)
        return Frame.from_dict({"Reconstruction.MSE": mse.cpu().numpy()})

    def predict(self, test_data: Frame) -> Frame:
        out = self._score(test_data)
        if self.problem == "autoencoder":
            # reconstructed inputs in the expanded coefficient space
            return Frame.from_dict(
                {f"reconstr_{n}": out[:, i]
                 for i, n in enumerate(self.dinfo.coef_names)})
        if self.problem in ("binomial", "multinomial"):
            lab = out.argmax(axis=1)
            d = {"predict": np.asarray(self.domain, dtype=object)[lab]}
            for i, cls in enumerate(self.domain):
                d[str(cls)] = out[:, i]
            return Frame.from_dict(d, column_types={"predict": "enum"})
        return Frame.from_dict({"predict": out[:, 0]})

    def _make_metrics(self, frame: Frame, X_pre=None):
        if self.problem == "autoencoder":
            X = X_pre if X_pre is not None else self._design(frame)
            rec = self._output(frame, X)
            mse = float(((rec.double() - X.double()) ** 2).mean())
            return ModelMetricsRegression(
                mse=mse, rmse=float(np.sqrt(mse)), nobs=frame.nrow,
                description="autoencoder reconstruction")
        out = self._score(frame, X_pre=X_pre)
        yv = frame.vec(self.y)
        if self.problem == "binomial":
            return ModelMetricsBinomial.make(np.asarray(yv.data), out[:, 1])
        if self.problem == "multinomial":
            return ModelMetricsMultinomial.make(np.asarray(yv.data), out)
        return ModelMetricsRegression.make(yv.numeric_np(), out[:, 0])


class _FlatNet:
    """Every W and b of the network in one f32 vector, in the reference's
    `_seg_offs` order (W0, b0, W1, b1, …), with views of it per layer."""

    def __init__(self, params: Params):
        self.shapes = [tuple(t.shape) for W, b in params for t in (W, b)]
        self.offs = np.concatenate(
            [[0], np.cumsum([int(np.prod(s)) for s in self.shapes])])
        self.n = int(self.offs[-1])
        self.weights = [2 * i for i in range(len(params))]   # W segments

    def flatten(self, params: Params) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for W, b in params for t in (W, b)])

    def seg(self, v: torch.Tensor, i: int) -> torch.Tensor:
        return v[int(self.offs[i]):int(self.offs[i + 1])].view(self.shapes[i])

    def segments(self, v: torch.Tensor) -> List[torch.Tensor]:
        return [self.seg(v, i) for i in range(len(self.shapes))]

    def unflatten(self, v: torch.Tensor) -> Params:
        segs = self.segments(v)
        return list(zip(segs[::2], segs[1::2]))


class H2ODeepLearningEstimator(H2OEstimator):
    algo = "deeplearning"
    _param_defaults = dict(
        activation="Rectifier",
        hidden=[200, 200],
        epochs=10.0,
        train_samples_per_iteration=-2,
        mini_batch_size=32,           # the reference's; H2O's is 1 (Hogwild)
        adaptive_rate=True,
        rho=0.99,
        epsilon=1e-8,
        rate=0.005,
        rate_annealing=1e-6,
        rate_decay=1.0,
        momentum_start=0.0,
        momentum_ramp=1e6,
        momentum_stable=0.0,
        nesterov_accelerated_gradient=True,
        input_dropout_ratio=0.0,
        hidden_dropout_ratios=None,
        l1=0.0,
        l2=0.0,
        max_w2=float("inf"),
        initial_weight_distribution="UniformAdaptive",
        initial_weight_scale=1.0,
        loss="Automatic",
        distribution="AUTO",
        score_interval=5.0,
        score_training_samples=10000,
        score_validation_samples=0,
        score_duty_cycle=0.1,
        overwrite_with_best_model=True,
        standardize=True,
        use_all_factor_levels=True,
        shuffle_training_data=False,
        reproducible=False,
        variable_importances=True,
        export_weights_and_biases=False,
        elastic_averaging=False,
        autoencoder=False,
    )

    def _is_supervised(self) -> bool:  # autoencoder trains without a response
        return not self._parms.get("autoencoder", False)

    @staticmethod
    def _check_params(p) -> Tuple[List[int], str]:
        """The reference's `ValueError`s, in its order, then the port's
        `NotImplementedError`s for what the reference accepts and ignores;
        returns (hidden, activation)."""
        raw_hidden = p.get("hidden")
        if raw_hidden is not None:
            raw_hidden = list(raw_hidden)     # materialize once (iterables)
            if not raw_hidden:
                raise ValueError("hidden must be a non-empty list of layer "
                                 "sizes (got [])")
        hidden = list(raw_hidden if raw_hidden is not None else [200, 200])
        if any((not float(h).is_integer()) or h < 1 for h in hidden):
            raise ValueError(
                f"hidden must be a non-empty list of positive layer sizes, "
                f"got {raw_hidden}")
        if float(p.get("epochs", 10.0)) <= 0:
            raise ValueError(f"epochs must be > 0, got {p.get('epochs')}")
        if int(p.get("mini_batch_size", 32)) < 1:
            raise ValueError("mini_batch_size must be >= 1, got "
                             f"{p.get('mini_batch_size')}")
        for k in ("input_dropout_ratio", "rho"):
            v = p.get(k)
            if v is not None and not (0.0 <= float(v) < 1.0):
                raise ValueError(f"{k} must be in [0, 1), got {v}")
        eps_v = p.get("epsilon")
        if eps_v is not None and not (0.0 < float(eps_v) <= 1.0):
            raise ValueError(f"epsilon must be in (0, 1], got {eps_v}")
        activation = p.get("activation", "Rectifier")
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
        check_unread("DeepLearning", _ITEM10, p, _UNREAD)
        if p.get("distribution") in ("gamma", "tweedie"):
            raise NotImplementedError(
                f"distribution={p.get('distribution')!r}: the reference's "
                "DeepLearning trains it on squared error and scores exp(out), "
                f"so it is not ported ({_ITEM10}; ROADMAP §C)")
        if (not p.get("adaptive_rate", True)
                and np.isfinite(float(p.get("max_w2", float("inf"))))):
            raise NotImplementedError(
                "max_w2 with adaptive_rate=False: the reference's momentum "
                f"SGD never applies it, so it is not ported ({_ITEM10}; "
                "ROADMAP §C)")
        return [int(h) for h in hidden], activation

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> DeepLearningModel:
        p = self._parms
        hidden, activation = self._check_params(p)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        seed = p["_actual_seed"]
        autoenc = bool(p.get("autoencoder", False))
        if autoenc:
            problem, nclass, domain = "autoencoder", 0, None
            dist = "gaussian"
        else:
            yvec = train.vec(y)
            problem, nclass, domain = response_info(yvec)
            dist = p.get("distribution", "AUTO")
            if dist == "AUTO":
                dist = {"binomial": "bernoulli",
                        "multinomial": "multinomial"}.get(problem, "gaussian")
        timings: Dict[str, float] = {}
        max_runtime = float(p.get("max_runtime_secs") or 0)
        # a time budget keeps the reference's per-batch path (its wall check
        # needs host control between steps); otherwise the chunked path
        use_scan = not max_runtime > 0
        if use_scan:
            # the reference's default path: its dataset cache builds the
            # device design from compact columns; the port builds it per fit
            dinfo, X_dev = _est.design_matrix(
                train, x, standardize=bool(p.get("standardize", True)),
                use_all=bool(p.get("use_all_factor_levels", True)),
                device=dev, timings=timings)
        else:
            # the per-batch path trains on the host design (f64
            # standardization rounded to f32), uploaded once; its scoring
            # events expand the frame on the device, as the reference's do
            dinfo = DataInfo(
                train, x, standardize=bool(p.get("standardize", True)),
                use_all_factor_levels=bool(
                    p.get("use_all_factor_levels", True)))
            t_pk = time.perf_counter()
            X_host = dinfo.fit_transform(train)
            t_h = time.perf_counter()
            X_dev = torch.from_numpy(X_host).to(dev)
            _sync(dev)
            timings.update(pack_s=t_h - t_pk, h2d_s=time.perf_counter() - t_h)
        X_score = X_dev if use_scan else None
        n, nfeat = train.nrow, int(X_dev.shape[1])
        if autoenc:
            K = nfeat  # reconstruct the (expanded, standardized) inputs
        else:
            K = nclass if problem in ("binomial", "multinomial") else 1
        sizes = [nfeat] + hidden + [K]

        t_up = time.perf_counter()
        if autoenc:
            yarr = np.zeros(n, np.float32)  # unused placeholder
        elif problem in ("binomial", "multinomial"):
            yarr = np.asarray(yvec.data, np.int64)
        else:
            yarr = yvec.numeric_np().astype(np.float32)
        w = (
            train.vec(p["weights_column"]).numeric_np()
            if p.get("weights_column")
            else np.ones(n)
        ).astype(np.float32)
        y_dev = torch.from_numpy(yarr).to(dev)
        w_dev = torch.from_numpy(w).to(dev)
        _sync(dev)
        timings["yw_h2d_s"] = time.perf_counter() - t_up
        batch = int(p.get("mini_batch_size", 32))

        key = prng.PRNGKey(seed & 0x7FFFFFFF)
        key, kinit = prng.split(key)
        params = _init_params(kinit, sizes, activation, dev)

        hidden_dropout = p.get("hidden_dropout_ratios")
        if hidden_dropout is None and activation.endswith("WithDropout"):
            hidden_dropout = [0.5] * len(hidden)
        hidden_dropout = tuple(hidden_dropout) if hidden_dropout else None
        input_dropout = float(p.get("input_dropout_ratio", 0.0))
        uses_keys = (input_dropout > 0
                     or any(d > 0 for d in hidden_dropout or ()))
        l1 = float(p.get("l1", 0.0))
        l2 = float(p.get("l2", 0.0))
        max_w2 = float(p.get("max_w2", float("inf")))
        adaptive = bool(p.get("adaptive_rate", True))
        # the optimizer's scalars as the reference's f32 device values
        f32 = np.float32
        rho = float(f32(p.get("rho", 0.99)))
        one_m_rho = float(f32(1 - float(p.get("rho", 0.99))))
        eps = float(f32(p.get("epsilon", 1e-8)))
        rate0 = f32(p.get("rate", 0.005))
        rate_annealing = f32(p.get("rate_annealing", 1e-6))
        mom_start = f32(p.get("momentum_start", 0.0))
        mom_ramp = f32(max(float(p.get("momentum_ramp", 1e6)), 1.0))
        mom_stable = f32(p.get("momentum_stable", 0.0))
        mom_delta = f32(float(p.get("momentum_stable", 0.0))
                        - float(p.get("momentum_start", 0.0)))
        mom_cap = max(mom_stable, mom_start)

        net = _FlatNet(params)

        def loss_fn(ps, xb, yb, wb, wsum, k):
            out = _forward(ps, xb, activation, hidden_dropout, input_dropout,
                           k, True)
            if autoenc:
                nll = ((out - xb) ** 2).mean(dim=1)
            elif problem in ("binomial", "multinomial"):
                nll = torch.nn.functional.cross_entropy(out, yb,
                                                        reduction="none")
            elif dist == "poisson":
                nll = torch.exp(out[:, 0]) - yb * out[:, 0]
            else:
                nll = 0.5 * (out[:, 0] - yb) ** 2
            loss = torch.dot(nll, wb) / wsum
            if l2 > 0:
                loss = loss + l2 * sum((W * W).sum() for W, _ in ps)
            if l1 > 0:
                # |W| with jax's derivative, +1 at 0 (torch.abs gives 0)
                loss = loss + l1 * sum(torch.where(W >= 0, W, -W).sum()
                                       for W, _ in ps)
            return loss

        def clamp_w2(pv):
            """Per-layer max_w2 column-norm clamp on the flat vector."""
            for i in net.weights:
                W = net.seg(pv, i)
                norms = (W * W).sum(dim=0, keepdim=True)
                W.mul_(torch.sqrt(torch.clamp(
                    max_w2 / torch.clamp(norms, min=1e-12), max=1.0)))

        def update(pv, state, gv, it):
            """One optimizer update of the flat vector, in place: ADADELTA
            (Neurons.java: the step −sqrt(E[Δ²] + ε) / sqrt(E[g²] + ε)·g,
            added by subtracting its negation, the same bits) or momentum
            SGD with the annealed rate."""
            if adaptive:
                eg2, ed2 = state
                eg2.mul_(rho).addcmul_(gv, gv, value=one_m_rho)
                d = (ed2 + eps).sqrt_().div_((eg2 + eps).sqrt_()).mul_(gv)
                ed2.mul_(rho).addcmul_(d, d, value=one_m_rho)
                pv.sub_(d)
                if np.isfinite(max_w2):
                    clamp_w2(pv)
                return
            itf = f32(it)
            rate = rate0 / (f32(1.0) + rate_annealing * itf)
            mom = min(mom_start + mom_delta * itf / mom_ramp, mom_cap)
            (vel,) = state
            vel.mul_(float(mom)).sub_(float(rate) * gv)
            pv.add_(vel)

        def step(pflat, state, xb, yb, wb, wsum, k, it_s):
            """One minibatch update. The gradient is taken with respect to
            detached views of the flat vector, one per W and b, and
            concatenated."""
            segs = [t.detach().requires_grad_(True)
                    for t in net.segments(pflat)]
            loss = loss_fn(list(zip(segs[::2], segs[1::2])), xb, yb, wb,
                           wsum, k)
            gv = torch.cat([g.reshape(-1) for g in
                            torch.autograd.grad(loss, segs)])
            with torch.no_grad():
                update(pflat, state, gv, it_s)

        def train_chunk(pflat, state, sub, it0, nsteps):
            """nsteps minibatch updates: one permutation of the rows, tiled
            and cut to nsteps·batch, gathered once and walked batch by
            batch."""
            kperm, kdrop = prng.split(sub)
            need = nsteps * batch
            perm = prng.permutation(kperm, n, dev)
            reps = -(-need // n)                       # ceil: allow short n
            sel = perm.repeat(reps)[:need]
            xs, ys, ws = (t.index_select(0, sel)
                          for t in (X_dev, y_dev, w_dev))
            wsums = torch.clamp(ws.view(nsteps, batch).sum(dim=1), min=1e-12)
            keys = prng.split(kdrop, nsteps) if uses_keys else [None] * nsteps
            for s in range(nsteps):
                lo, hi = s * batch, (s + 1) * batch
                step(pflat, state, xs[lo:hi], ys[lo:hi], ws[lo:hi], wsums[s],
                     keys[s], it0 + s)

        epochs = float(p.get("epochs", 10.0))
        tspi = int(p.get("train_samples_per_iteration", -2))
        score_every = tspi if tspi > 0 else max(n, batch)
        stopper = (
            ScoreKeeper(int(p.get("stopping_rounds", 0)),
                        "logloss" if problem != "regression" else "deviance",
                        float(p.get("stopping_tolerance", 1e-3)))
            if int(p.get("stopping_rounds", 0)) > 0 else None
        )

        rng = np.random.default_rng(seed)
        total = int(epochs * n)
        seen = 0
        it = 0
        next_score = score_every
        history: List[Dict] = []
        t_loop = time.time()
        model = DeepLearningModel(self, x, y, dinfo, problem, nclass, domain,
                                  params, activation, dist, device=dev)
        pflat = net.flatten(params)
        state = tuple(torch.zeros(net.n, dtype=torch.float32, device=dev)
                      for _ in range(2 if adaptive else 1))
        _sync(dev)
        t_init = time.perf_counter()
        _score_time = 0.0
        steps_s = 0.0
        while seen < total:
            if self.job is not None:
                self.job.check_cancelled()
            t_c = time.perf_counter()
            if use_scan:
                upto = min(next_score, total)
                steps = max(1, -(-int(upto - seen) // batch))
                key, sub = prng.split(key)
                train_chunk(pflat, state, sub, it, steps)
                seen += max(steps * batch, 1)
                it += steps
            else:
                # one step on rows drawn with replacement by numpy; the
                # step's key feeds its dropout masks directly
                idx = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
                key, sub = prng.split(key)
                wb = w_dev[idx]
                step(pflat, state, X_dev[idx], y_dev[idx], wb,
                     torch.clamp(wb.sum(), min=1e-12),
                     sub if uses_keys else None, it)
                seen += batch
                it += 1
            _sync(dev)
            steps_s += time.perf_counter() - t_c
            if seen >= next_score or seen >= total:
                next_score += score_every
                # train_samples_per_iteration=-2 (auto-tune): cap the wall
                # share spent scoring at score_duty_cycle, like the
                # reference's computeSamplesPerIteration duty-cycle target.
                # Early stopping keeps every event (scoring is its signal),
                # as does the final event and score_each_iteration.
                if (seen < total and stopper is None and tspi == -2
                        and not max_runtime
                        and not p.get("score_each_iteration")):
                    if _score_time > float(
                            p.get("score_duty_cycle", 0.1) or 0.1) * max(
                            time.time() - t_loop, 1e-9):
                        if self.job is not None:
                            self.job.update(min(seen / total, 1.0))
                        continue
                _t_sc = time.time()
                model.net_params = net.unflatten(pflat)
                sm = model._make_metrics(train, X_pre=X_score)
                ev = {
                    "epochs": seen / n, "iterations": it,
                    "samples": seen, "timestamp": time.time(),
                }
                if problem in ("regression", "autoencoder"):
                    ev["deviance"] = sm.mse
                    metric_val = sm.mse
                else:
                    ev["logloss"] = sm.logloss
                    metric_val = sm.logloss
                history.append(ev)
                stop = stopper is not None and stopper.record(metric_val)
                _score_time += time.time() - _t_sc
                if stop:
                    break
            if max_runtime and time.time() - t_loop > max_runtime:
                break
            if self.job is not None:
                self.job.update(min(seen / total, 1.0))

        t_steps = time.perf_counter()
        model.net_params = [(W.clone(), b.clone())
                            for W, b in net.unflatten(pflat)]
        model.scoring_history = ScoringHistory(history)
        model.training_metrics = model._make_metrics(train, X_pre=X_score)
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        model.iterations = it
        # host-clock split of the fit (the device is synchronised at each
        # mark): the design's host pack, upload and expansion, the labels'
        # and weights' upload, the step loop, the scoring events and the
        # final training and validation metrics
        model.fit_timings = dict(
            timings, init_s=t_init - t_up - timings["yw_h2d_s"],
            steps_s=steps_s, scoring_s=_score_time,
            metrics_s=t_end - t_steps, total_s=t_end - t0)
        return model

    def _cv_predict(self, model: DeepLearningModel, frame: Frame) -> np.ndarray:
        out = model._score(frame)
        if model.problem == "binomial":
            return out[:, 1]
        if model.problem == "multinomial":
            return out
        return out[:, 0]


DeepLearning = H2ODeepLearningEstimator
