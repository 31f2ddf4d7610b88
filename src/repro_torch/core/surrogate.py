"""Learned surrogate cost model: predict the exact simulator from its own cache.

The port of ``repro/core/surrogate.py``.  The DSE engine
(``repro_torch.core.dse``) evaluates (app, config) cells *exactly*, but
exhaustive simulation tops out around the 1536-point ``SPACE_FULL`` grid.
This module trains a small MLP on the simulator's own ``ResultCache``
entries so a candidate's runtime can be *predicted* in microseconds, and
the search layer (``repro_torch.core.search``) re-simulates only the
predicted-frontier survivors.

The contract, in three parts:

* **Features** (:func:`row_features`): a per-(trace, config) vector — the
  app's trace-mix features (instruction-kind/FU/memory-pattern histograms,
  element counts, footprints, chunk count, scalar residue) crossed with
  every ``VectorEngineConfig`` knob, all ``log1p``-compressed then
  standardized.  Host numpy, bitwise the reference's.
* **Training** (:func:`fit`): rows mined from a ``ResultCache`` by
  ``ResultCache.export_training_rows`` (a pure join — no re-simulation),
  log-runtime targets, AdamW + cosine LR from ``repro_torch.train.
  optimizer``, full-batch steps on the device, the per-step losses kept
  there until the end (as the reference's ``lax.scan`` keeps them).
* **Inference** (:class:`SpaceScorer`): flat design-space indices are
  decoded (mixed radix, matching ``DesignSpace.config_at``), featurized and
  scored on the device in fixed ``SCORE_BATCH`` chunks — no per-candidate
  Python and no ``VectorEngineConfig`` built.

The parameters keep the reference's names (``w1``, ``b1`` ... ``b3``), so
carrying a reference model across (``interop.surrogate_from_numpy``) is a
copy.  Float32 products run in full float32 (no TF32): survivor selection
compares predictions at the 1e-7 level.  Determinism: the initial weights
come from a CPU ``torch.Generator`` (the same start on the host and on the
card), every step is the same sequence of operations on the same shapes,
so a refit with the same seed is bitwise the same; the scorer's fixed
batch shape keeps a point's score independent of the batch it rides in.

Accuracy is never assumed: :func:`scorecard` emits the pred-vs-true
relative-error CDF, per-app worst case and Spearman rank correlation, and
the search layer re-simulates every reported frontier point exactly.

The engine-facing entry points run on the CUDA device unless
``device="cpu"`` is given.

>>> spearman([1.0, 2.0, 3.0, 4.0], [10.0, 20.0, 30.0, 40.0])
1.0
>>> spearman([1.0, 2.0, 3.0], [3.0, 2.0, 1.0])
-1.0
>>> len(CONFIG_FEATURES) == len(_CFG_FIELDS)
True
"""
from __future__ import annotations

from dataclasses import dataclass, fields as _dc_fields

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import engine as eng
from repro_torch.core import isa, tracegen
from repro_torch.kernels.ref import _full_float32_matmul
from repro_torch.train import optimizer

_CFG_FIELDS = _dc_fields(eng.VectorEngineConfig)

# --------------------------------------------------------------------------
# config features: every live VectorEngineConfig knob, numerically encoded
# --------------------------------------------------------------------------

CONFIG_FEATURES: tuple = tuple(f.name for f in _CFG_FIELDS)


def cfg_field_numeric(name: str, value) -> float:
    """Numeric encoding of one config field (bools 0/1, ``interconnect``:
    ring=1 / crossbar=0, everything else already a number)."""
    if name == "interconnect":
        return 1.0 if value == "ring" else 0.0
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    return float(value)


def config_features(cfg: eng.VectorEngineConfig) -> np.ndarray:
    """The config half of a feature row: every field of the config,
    numerically encoded, in ``CONFIG_FEATURES`` order."""
    return np.asarray([cfg_field_numeric(n, getattr(cfg, n))
                       for n in CONFIG_FEATURES], np.float32)


CONFIG_FEATURE_DEFAULTS = config_features(eng.VectorEngineConfig())

# --------------------------------------------------------------------------
# trace features: the app side, a pure function of (app, cfg.mvl)
# --------------------------------------------------------------------------

TRACE_FEATURES = (
    # loop-body shape (counts per instruction kind)
    "body_len", "n_vector", "n_scalar_blocks",
    "kind_arith", "kind_load", "kind_store", "kind_slide",
    "kind_reduce", "kind_mask2s", "kind_move",
    # FU mix of the vector instructions
    "fu_simple", "fu_mul", "fu_div", "fu_trans",
    # memory access patterns
    "mem_unit", "mem_strided", "mem_indexed",
    # element-level work
    "elems_total", "elems_mem", "avg_vl_body",
    # scalar-core coupling
    "scalar_per_chunk", "dep_scalar_blocks",
    # working sets
    "footprint_max_kb", "footprint_mean_kb",
    # whole-app scale (the closed forms the runtime derivation uses)
    "chunks", "residual_scalar",
    # characterization-level mix (paper §4 definitions)
    "pct_vectorization", "avg_vl_counts", "eff_mvl",
)

# Every loop body consumes its config through cfg.mvl only, so the feature
# table keys on (app, cfg.mvl) instead of the whole config — what makes
# million-point scoring a table lookup.  ``dse.cell_body`` keys its body
# memo the same way.
_TRACE_FEATS: dict[tuple, np.ndarray] = {}


def trace_features(app_name: str, mvl: int) -> np.ndarray:
    """The trace half of a feature row for one (app, configured MVL) pair."""
    key = (app_name, int(mvl))
    out = _TRACE_FEATS.get(key)
    if out is not None:
        return out
    from repro_torch.core import suite
    cfg = eng.VectorEngineConfig(mvl=int(mvl))
    eff = suite.effective_mvl(app_name, cfg)
    body = tracegen.body_for(app_name, eff, cfg)
    chunks = tracegen.chunks_for(app_name, eff, cfg)
    counts = tracegen.app_for(app_name).counts(int(mvl))
    kinds = isa.kind_histogram(body)
    vec = body.kind != isa.SCALAR_BLOCK
    is_mem = (body.kind == isa.VLOAD) | (body.kind == isa.VSTORE)
    vls = body.vl[vec].astype(np.float64)
    n_vec = int(vec.sum())
    fu_hist = np.bincount(body.fu[vec], minlength=isa.N_FU_CLASSES)
    pat_hist = np.bincount(body.mem_pattern[is_mem], minlength=3)
    scalar_per_chunk = float(body.scalar_count.sum())
    residual = max(counts.scalar_instrs - scalar_per_chunk * chunks, 0.0)
    fp = body.footprint_kb[is_mem]
    vals = {
        "body_len": float(len(body)),
        "n_vector": float(n_vec),
        "n_scalar_blocks": float((body.kind == isa.SCALAR_BLOCK).sum()),
        "kind_arith": float(kinds[isa.VARITH]),
        "kind_load": float(kinds[isa.VLOAD]),
        "kind_store": float(kinds[isa.VSTORE]),
        "kind_slide": float(kinds[isa.VSLIDE]),
        "kind_reduce": float(kinds[isa.VREDUCE]),
        "kind_mask2s": float(kinds[isa.VMASK_SCALAR]),
        "kind_move": float(kinds[isa.VMOVE]),
        "fu_simple": float(fu_hist[isa.FU_SIMPLE]),
        "fu_mul": float(fu_hist[isa.FU_MUL]),
        "fu_div": float(fu_hist[isa.FU_DIV]),
        "fu_trans": float(fu_hist[isa.FU_TRANS]),
        "mem_unit": float(pat_hist[isa.MEM_UNIT]),
        "mem_strided": float(pat_hist[isa.MEM_STRIDED]),
        "mem_indexed": float(pat_hist[isa.MEM_INDEXED]),
        "elems_total": float(vls.sum()),
        "elems_mem": float(body.vl[is_mem].sum()),
        "avg_vl_body": float(vls.mean()) if n_vec else 0.0,
        "scalar_per_chunk": scalar_per_chunk,
        "dep_scalar_blocks": float(body.dep_scalar.sum()),
        "footprint_max_kb": float(fp.max()) if fp.size else 0.0,
        "footprint_mean_kb": float(fp.mean()) if fp.size else 0.0,
        "chunks": float(chunks),
        "residual_scalar": float(residual),
        "pct_vectorization":
            counts.vector_ops / (counts.scalar_instrs + counts.vector_ops),
        "avg_vl_counts": counts.vector_ops / max(counts.total_vector, 1),
        "eff_mvl": float(eff),
    }
    out = np.asarray([vals[n] for n in TRACE_FEATURES], np.float32)
    _TRACE_FEATS[key] = out
    return out


N_FEATURES = len(CONFIG_FEATURES) + len(TRACE_FEATURES)


def row_features(app_name: str, cfg: eng.VectorEngineConfig) -> np.ndarray:
    """One raw (un-standardized) feature row: config knobs ++ trace mix."""
    return np.concatenate([config_features(cfg),
                           trace_features(app_name, cfg.mvl)])


# --------------------------------------------------------------------------
# the model: log1p -> standardize -> 2-hidden-layer MLP -> log runtime
# --------------------------------------------------------------------------

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclass
class Surrogate:
    """A trained surrogate: standardization stats + MLP parameters + the
    provenance needed to trust (or distrust) it.  ``params`` are float32
    tensors on one device, which is where the model predicts."""
    feat_mean: np.ndarray          # [F] mean of log1p features, train set
    feat_std: np.ndarray           # [F] std  of log1p features, train set
    params: dict                   # {"w1","b1","w2","b2","w3","b3"}
    apps: tuple                    # apps present in the training rows
    meta: dict                     # n_rows / steps / seed / final_loss / ...

    @property
    def device(self) -> torch.device:
        return self.params["w1"].device

    def predict_runtime_ns(self, rows) -> np.ndarray:
        """Predicted whole-app runtimes (ns) for export_training_rows-style
        rows — the row-at-a-time inference path (tests, scorecards).  The
        bulk path is :class:`SpaceScorer`."""
        X = np.stack([row_features(r["app"], r["cfg"]) for r in rows])
        dev = self.device
        mean, std = (torch.from_numpy(a).to(dev)
                     for a in (self.feat_mean, self.feat_std))
        with _full_float32_matmul():
            out = _forward(self.params, _standardize(
                torch.from_numpy(np.log1p(X)).to(dev), mean, std))
            pred = torch.exp(torch.clamp(out, *_LOG_CLIP))
        return pred.cpu().numpy()


def _standardize(Xl: torch.Tensor, mean, std) -> torch.Tensor:
    """``(log1p(X) - mean) / std`` of features whose ``log1p`` was taken on
    the host (``np.log1p``, as ``fit`` takes it).  A device ``log1p`` may
    round one ulp off numpy's, and a feature the training rows never varied
    can have a float32 std of ~1e-6 rather than 0 (its float32 mean is not
    exact), which would turn that ulp into ~0.07 of a standardized input;
    the host ``log1p`` keeps inference's inputs bitwise training's."""
    return (Xl - mean) / std


# log-runtime predictions are clamped to a generous physical band before
# exponentiation (1 ns .. ~5e21 ns) so far-out-of-distribution candidates
# rank as "terrible", never as inf/nan
_LOG_CLIP = (0.0, 50.0)


def _forward(params: dict, X: torch.Tensor) -> torch.Tensor:
    h = torch.relu(X @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"] + params["b3"])[:, 0]


def _init_params(n_in: int, hidden: int, seed: int, device=None) -> dict:
    """He-initialized weights drawn from a CPU generator seeded with
    ``seed`` (the same start on every device), zero biases."""
    gen = torch.Generator("cpu").manual_seed(seed)
    he = lambda i, o: (torch.randn((i, o), generator=gen,
                                   dtype=torch.float32)
                       * np.float32(np.sqrt(2.0 / i)))
    params = {
        "w1": he(n_in, hidden), "b1": torch.zeros(hidden),
        "w2": he(hidden, hidden), "b2": torch.zeros(hidden),
        "w3": he(hidden, 1), "b3": torch.zeros(1),
    }
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {k: v.to(dev) for k, v in params.items()}


def _loss(params: dict, Xn: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((_forward(params, Xn) - y) ** 2)


def _train(params: dict, Xn: torch.Tensor, y: torch.Tensor,
           opt_cfg: optimizer.OptConfig, steps: int):
    """``steps`` full-batch AdamW steps from ``params`` on (Xn, y), all on
    their device.  Returns ``(params, losses)``, ``losses`` the [steps]
    float32 tensor of each step's loss before its update (the reference's
    ``lax.scan`` outputs), left on the device."""
    state = optimizer.init(params)
    grad_and_loss = torch.func.grad_and_value(_loss)
    losses = torch.empty(steps, dtype=torch.float32, device=Xn.device)
    with _full_float32_matmul():
        for i in range(steps):
            g, loss = grad_and_loss(params, Xn, y)
            losses[i] = loss
            params, state, _ = optimizer.apply(opt_cfg, params, g, state)
    return params, losses


def fit(rows, hidden: int = 64, steps: int = 1500, lr: float = 3e-3,
        seed: int = 0, device=None) -> Surrogate:
    """Train a surrogate on ``ResultCache.export_training_rows`` rows.

    Targets are ``log(runtime_ns)`` (runtimes span ~4 decades across the
    suite; the log makes the MSE a *relative*-error objective).  AdamW with
    global-norm clipping and warmup+cosine LR from
    ``repro_torch.train.optimizer``, full-batch gradient steps on
    ``device`` (default: the CUDA device).  Deterministic in (rows,
    hyperparameters, seed) on one device.
    """
    if not rows:
        raise ValueError("fit() needs at least one training row")
    dev = _device.resolve(device)
    X = np.stack([row_features(r["app"], r["cfg"]) for r in rows])
    y = np.log(np.asarray([r["runtime_ns"] for r in rows], np.float32))
    Xl = np.log1p(X)
    mean = Xl.mean(axis=0)
    # Features constant across the training rows (a knob the mined sweep
    # never varied) get std=1, NOT a tiny floor: they standardize to ~0 in
    # training so the model ignores them, and stay bounded when the search
    # space later sweeps them — a 1e-6 floor would turn any unseen choice
    # into a +-10^5 activation and a nonsense (inf) prediction.
    std = Xl.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    Xn = torch.from_numpy(np.ascontiguousarray((Xl - mean) / std)).to(dev)
    yt = torch.from_numpy(y).to(dev)

    opt_cfg = optimizer.OptConfig(
        lr=lr, b1=0.9, b2=0.95, weight_decay=1e-4, clip_norm=1.0,
        warmup_steps=min(100, steps // 10 + 1), total_steps=steps,
        min_lr_frac=0.02)
    params = _init_params(Xn.shape[1], hidden, seed, dev)
    params, losses = _train(params, Xn, yt, opt_cfg, steps)
    return Surrogate(
        feat_mean=mean.astype(np.float32), feat_std=std.astype(np.float32),
        params=params,
        apps=tuple(sorted({r["app"] for r in rows})),
        meta={"n_rows": len(rows), "hidden": hidden, "steps": steps,
              "lr": lr, "seed": seed,
              "final_loss": float(losses[-1]),
              "model_fp": eng.model_fingerprint()})


# --------------------------------------------------------------------------
# bulk inference: score flat DesignSpace indices on the device
# --------------------------------------------------------------------------

SCORE_BATCH = 1 << 17     # fixed batch: one shape for every product


class SpaceScorer:
    """Batched surrogate inference over a ``DesignSpace`` for one app.

    ``score(idx)`` takes *flat candidate indices* and returns
    ``(predicted runtime_ns, exact area_kb)``.  Indices are decoded to axis
    digits by the same mixed-radix rule as ``DesignSpace.config_at`` (last
    axis fastest), feature columns are assembled from per-axis choice tables
    (unlisted knobs sit at their defaults; each table also in its ``log1p``,
    taken on the host as ``fit`` takes it), the app's trace features are a
    per-MVL-choice table lookup, and the area proxy is ``dse.area_proxy_kb``
    spelled over the columns — so no ``VectorEngineConfig`` object is ever
    built on the scoring path.  Work runs on the model's device in fixed
    ``SCORE_BATCH`` chunks (pad + mask): cuBLAS picks its algorithm by
    shape, so one shape keeps a point's score independent of its batch.
    """

    def __init__(self, model: Surrogate, space, app: str):
        self.model = model
        self.space = space
        self.app = app
        dev = model.device
        axes = list(space.axes)
        self._radices = [len(c) for _, c in axes]
        # per-axis numeric choice tables + their CONFIG_FEATURES column
        self._axis_cols = [CONFIG_FEATURES.index(n) for n, _ in axes]
        vals = [np.asarray([cfg_field_numeric(n, v) for v in choices],
                           np.float32) for n, choices in axes]
        self._axis_vals = [torch.from_numpy(v).to(dev) for v in vals]
        # and their log1p, taken on the host (see _standardize)
        self._axis_logs = [torch.from_numpy(np.log1p(v)).to(dev)
                           for v in vals]
        # the app's trace features per mvl choice (one row if mvl not swept)
        mvl_axis = [i for i, (n, _) in enumerate(axes) if n == "mvl"]
        self._mvl_axis = mvl_axis[0] if mvl_axis else None
        mvls = (axes[self._mvl_axis][1] if self._mvl_axis is not None
                else (eng.VectorEngineConfig().mvl,))
        self._trace_log_tab = torch.from_numpy(np.log1p(
            np.stack([trace_features(app, m) for m in mvls]))).to(dev)
        self._defaults = torch.from_numpy(CONFIG_FEATURE_DEFAULTS).to(dev)
        self._default_logs = torch.from_numpy(
            np.log1p(CONFIG_FEATURE_DEFAULTS)).to(dev)
        self._mean = torch.from_numpy(model.feat_mean).to(dev)
        self._std = torch.from_numpy(model.feat_std).to(dev)

    def _score_batch(self, idx: torch.Tensor):
        """idx: [SCORE_BATCH] int64 on the device -> (pred runtime_ns,
        area_kb), float32 on the device."""
        from repro_torch.core import dse
        n_axes = len(self._radices)
        rem = idx
        digits = [None] * n_axes
        for a in range(n_axes - 1, -1, -1):     # last axis fastest
            r = self._radices[a]
            digits[a] = torch.remainder(rem, r)
            rem = torch.div(rem, r, rounding_mode="floor")
        # config feature matrix (raw for the area, log1p for the model):
        # defaults, overridden per swept axis
        B = idx.shape[0]
        cfg_mat = self._defaults.expand(B, -1).clone()
        cfg_log = self._default_logs.expand(B, -1).clone()
        for a in range(n_axes):
            c = self._axis_cols[a]
            cfg_mat[:, c] = self._axis_vals[a][digits[a]]
            cfg_log[:, c] = self._axis_logs[a][digits[a]]
        trace_log = (self._trace_log_tab[digits[self._mvl_axis]]
                     if self._mvl_axis is not None
                     else self._trace_log_tab[0].expand(B, -1))
        Xl = torch.cat([cfg_log, trace_log], dim=1)
        pred = torch.exp(torch.clamp(_forward(
            self.model.params, _standardize(Xl, self._mean, self._std)),
            *_LOG_CLIP))
        # dse.area_proxy_kb, spelled over the feature columns
        g = lambda name: cfg_mat[:, CONFIG_FEATURES.index(name)]
        area = (g("phys_regs") * g("mvl") * 8.0 / 1024.0
                + dse.LANE_AREA_KB * g("lanes")
                + g("l1_kb") + dse.L2_SHARED_FRACTION * g("l2_kb")
                + dse.ENTRY_AREA_KB * (g("rob_entries")
                                       + 2.0 * g("queue_entries")
                                       + g("mshrs")))
        return pred, area

    def score(self, idx) -> tuple[np.ndarray, np.ndarray]:
        """Score any number of flat indices (padded to ``SCORE_BATCH``
        multiples internally); returns ``(pred_runtime_ns, area_kb)``.
        The indices go to the device in one copy and the scores come back
        in one."""
        idx = np.asarray(idx, np.int64)
        n = len(idx)
        n_pad = -(-n // SCORE_BATCH) * SCORE_BATCH
        padded = np.zeros(n_pad, np.int64)
        padded[:n] = idx
        dev = self.model.device
        idx_dev = torch.from_numpy(padded).to(dev)
        preds = torch.empty(n_pad, dtype=torch.float32, device=dev)
        areas = torch.empty(n_pad, dtype=torch.float32, device=dev)
        with _full_float32_matmul():
            for lo in range(0, n_pad, SCORE_BATCH):
                p, a = self._score_batch(idx_dev[lo:lo + SCORE_BATCH])
                preds[lo:lo + SCORE_BATCH] = p
                areas[lo:lo + SCORE_BATCH] = a
        return preds[:n].cpu().numpy(), areas[:n].cpu().numpy()


# --------------------------------------------------------------------------
# the accuracy scorecard: every speed claim carries a trust number
# --------------------------------------------------------------------------

def _ranks(x) -> np.ndarray:
    """Average ranks (ties share their mean rank), scipy-free."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="mergesort")
    r = np.empty(len(x), np.float64)
    r[order] = np.arange(len(x), dtype=np.float64)
    _, inv, cnt = np.unique(x, return_inverse=True, return_counts=True)
    sums = np.zeros(len(cnt))
    np.add.at(sums, inv, r)
    return sums[inv] / cnt[inv]


def spearman(a, b) -> float:
    """Spearman rank correlation (average-rank tie handling)."""
    ra, rb = _ranks(a), _ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def scorecard(model: Surrogate, rows, holdout_app: str | None = None) -> dict:
    """Pred-vs-true accuracy report over labeled rows.

    Emits the relative-error CDF percentiles (p50/p90/p99/max on the natural
    runtime scale), per-app mean/worst error and Spearman rank correlation.
    When ``holdout_app`` names an app in ``rows``, its block is additionally
    surfaced as ``holdout`` — train the model *without* that app and this is
    the honest unseen-workload generalization number.
    """
    pred = model.predict_runtime_ns(rows)
    true = np.asarray([r["runtime_ns"] for r in rows], np.float64)
    rel = np.abs(pred - true) / true
    apps = sorted({r["app"] for r in rows})
    per_app = {}
    for app in apps:
        m = np.asarray([r["app"] == app for r in rows])
        per_app[app] = {
            "n": int(m.sum()),
            "mean_rel_err": float(rel[m].mean()),
            "worst_rel_err": float(rel[m].max()),
            "spearman": spearman(pred[m], true[m]),
            "trained_on": app in model.apps,
        }
    card = {
        "n_rows": len(rows),
        "rel_err_p50": float(np.percentile(rel, 50)),
        "rel_err_p90": float(np.percentile(rel, 90)),
        "rel_err_p99": float(np.percentile(rel, 99)),
        "rel_err_max": float(rel.max()),
        "spearman_all": spearman(pred, true),
        "per_app": per_app,
    }
    if holdout_app is not None and holdout_app in per_app:
        card["holdout"] = dict(per_app[holdout_app], app=holdout_app)
    return card
