"""Gradient-boosted trees by the histogram method, on one device.

The counterpart of ``raydp_tpu/train/gbt.py``. On the host, in numpy as
there: quantile binning (NaN sorts into the last bin), the flat tree
arrays (node i → children 2i+1 and 2i+2, ``feature`` -1 where a node does
not split), save and restore (the same ``trees.npz`` + ``gbt.json``, so a
model the JAX package saved restores here) and the eval metrics. On the
device, as torch ops (the reference's are XLA-generated, no Pallas):

* each level's split statistics are one ``index_add_`` into a
  ``[nodes × features × bins]`` histogram, with a trash slot for rows no
  longer active (:func:`_level_histograms`);
* the split search is a cumsum over the bins, in the reference's order
  of additions (:func:`_cumsum_last`), and an argmax
  (:func:`_best_splits`);
* rows descend a fitted tree by gathers (:func:`_route_tree`), and the
  leaves are one more ``index_add_`` over the node each row stopped in;
* prediction loops over the trees on the device.

Each level sends the chosen splits to the host, as the reference does.
On a card ``index_add_`` of float32 sums with atomics, so the order of a
histogram's sums, and their last bits, vary from run to run; a near-tie
in the gain can then pick another split than the CPU. On the CPU the sums
run in row order. One device: ``data_parallel`` is accepted for the
reference's signature (rows shard over devices there).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["GBTEstimator"]


def _quantile_bins(col: np.ndarray, max_bins: int) -> np.ndarray:
    """Bin edges (at most ``max_bins - 1``) from the quantiles of a column,
    NaN excluded; at binning time NaN rows sort into the last bin."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    with np.errstate(all="ignore"):
        edges = np.unique(np.nanquantile(col, qs))
    return edges[~np.isnan(edges)].astype(np.float32)


def _route_tree(binned: torch.Tensor, feat: torch.Tensor, bins: torch.Tensor,
                depth: int) -> torch.Tensor:
    """The node of one fitted flat tree that each row ends in: a bin at or
    below the split's goes left, a node without a split holds its rows.
    Training, evaluation and prediction all descend through this."""
    node = torch.zeros(binned.shape[0], dtype=torch.int64,
                       device=binned.device)
    for _ in range(depth):
        nf, nb = feat[node], bins[node]
        row_bin = torch.gather(binned, 1, nf.clamp_min(0)[:, None])[:, 0]
        child = torch.where(row_bin <= nb, 2 * node + 1, 2 * node + 2)
        node = torch.where(nf >= 0, child, node)
    return node


def _level_histograms(binned: torch.Tensor, node_rel: torch.Tensor,
                      active: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, n_nodes: int, n_feat: int,
                      n_bins: int):
    """The grad and hess sums of every (node, feature, bin) of one level,
    ``[n_nodes, n_feat, n_bins]`` each, as one ``index_add_`` per
    statistic; inactive rows go to a trash slot past the end."""
    dev = binned.device
    feats = torch.arange(n_feat, device=dev)
    keys = (node_rel[:, None] * n_feat + feats[None, :]) * n_bins + binned
    trash = n_nodes * n_feat * n_bins
    flat = torch.where(active[:, None], keys, trash).reshape(-1)
    out = []
    for stat in (grad, hess):
        sums = torch.zeros(trash + 1, dtype=stat.dtype, device=dev)
        sums.index_add_(0, flat, stat[:, None].expand(-1, n_feat).reshape(-1))
        out.append(sums[:trash].reshape(n_nodes, n_feat, n_bins))
    return out[0], out[1]


# The block length of XLA's rewrite of a long cumulative sum.
_SCAN_BLOCK = 16


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums over the last dim, added in the order
    the reference's ``jnp.cumsum`` adds them: XLA rewrites a cumsum longer
    than 16 into sequential sums within blocks of 16, plus the running
    sum of the earlier blocks' totals (recursively). A sum in another
    order differs in its last bits, and a near-zero gain can then change
    sign (``torch.cumsum`` on the CPU accumulates in float64)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols, acc = [], None
        for i in range(n):
            acc = x[..., i] if acc is None else acc + x[..., i]
            cols.append(acc)
        return torch.stack(cols, dim=-1)
    n_blocks = -(-n // _SCAN_BLOCK)
    padded = F.pad(x, (0, n_blocks * _SCAN_BLOCK - n))
    within = _cumsum_last(padded.reshape(
        x.shape[:-1] + (n_blocks, _SCAN_BLOCK)))
    before = F.pad(_cumsum_last(within[..., -1])[..., :-1], (1, 0))
    return (within + before[..., None]).reshape(padded.shape)[..., :n]


def _best_splits(gsum: torch.Tensor, hsum: torch.Tensor, lam: float,
                 n_nodes: int):
    """Each node's best (feature, bin, gain) from the level's histogram:
    the split "bin <= b" scored by G²/(H + λ) on each side less the
    node's, the last bin (no split) at -inf, the first maximum taken."""
    gl = _cumsum_last(gsum)
    hl = _cumsum_last(hsum)
    gt, ht = gl[:, :1, -1:], hl[:, :1, -1:]      # node totals [nodes, 1, 1]
    gr, hr = gt - gl, ht - hl

    def score(g, h):
        # The floor keeps an empty side at lam 0 from 0/0 = NaN, which
        # argmax would take as the maximum.
        return (g * g) / torch.clamp(h + lam, min=1e-12)

    gain = score(gl, hl) + score(gr, hr) - score(gt, ht)
    gain[:, :, -1] = -torch.inf
    flat = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat, dim=1)
    n_bins = gsum.shape[2]
    return best // n_bins, best % n_bins, flat.gather(1, best[:, None])[:, 0]


class GBTEstimator:
    """Histogram gradient-boosted trees with the other estimators'
    surface: ``fit``, ``predict``, ``predict_on_ds``, ``evaluate``,
    ``save`` and ``restore``. Losses: ``squared`` and ``logistic``."""

    def __init__(
        self,
        n_trees: int = 50,
        max_depth: int = 6,
        learning_rate: float = 0.3,
        reg_lambda: float = 1.0,
        max_bins: int = 64,
        loss: str = "squared",
        feature_columns: Optional[List[str]] = None,
        label_column: Optional[str] = None,
        min_split_gain: float = 0.0,
        data_parallel: bool = True,
        device: DeviceLike = "cuda",
    ):
        if loss not in ("squared", "logistic"):
            raise ValueError("loss must be 'squared' or 'logistic'")
        self.device = resolve_device(device)
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.max_bins = max_bins
        self.loss = loss
        self.feature_columns = feature_columns
        self.label_column = label_column
        self.min_split_gain = min_split_gain
        self.data_parallel = data_parallel
        # Fitted state: quantile edges per feature, [T, nodes] flat trees.
        self._edges: Optional[List[np.ndarray]] = None
        self._trees = None
        self._base_score = 0.0
        self.history: List[dict] = []

    # -- data access ----------------------------------------------------
    def _matrix_from_ds(self, ds, with_label: bool = True):
        names = list(self.feature_columns) + (
            [self.label_column] if with_label else [])
        cols = {}
        for rank in range(ds.num_shards):
            for k, v in ds.shard_columns(rank, names).items():
                cols.setdefault(k, []).append(np.asarray(v))
        X = np.stack([np.concatenate(cols[c]).astype(np.float32)
                      for c in self.feature_columns], axis=1)
        if not with_label:
            return X
        return X, np.concatenate(cols[self.label_column]).astype(np.float32)

    def _bin(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape, dtype=np.int32)
        for f, edges in enumerate(self._edges):
            out[:, f] = np.searchsorted(edges, X[:, f], side="left")
        return out

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- training -------------------------------------------------------
    def fit(self, train_ds, evaluate_ds=None, num_epochs=None):
        """Boost ``n_trees`` rounds (``num_epochs`` overrides the count:
        a round is this estimator's epoch). ``evaluate_ds`` adds each
        round's ``eval_loss`` to the history."""
        if not self.feature_columns or not self.label_column:
            raise ValueError(
                "feature_columns and label_column must be configured")
        X, y = self._matrix_from_ds(train_ds)
        eval_xy = (self._matrix_from_ds(evaluate_ds)
                   if evaluate_ds is not None else None)
        return self._fit_matrix(X, y, eval_xy=eval_xy, n_rounds=num_epochs)

    def fit_on_df(self, train_df, evaluate_df=None, num_shards=None):
        """DataFrame → :class:`MLDataset` (2 shards by default, as the
        JAX package) → :meth:`fit`."""
        from raydp_tpu_torch.data import MLDataset

        ds = MLDataset.from_df(train_df, num_shards=num_shards or 2)
        eval_ds = (MLDataset.from_df(evaluate_df, num_shards=num_shards or 2)
                   if evaluate_df is not None else None)
        return self.fit(ds, evaluate_ds=eval_ds)

    def _loss_of(self, pred, y, n_real: int) -> float:
        if self.loss == "squared":
            per_row = (pred - y) ** 2
        else:
            per_row = -(y * F.logsigmoid(pred) + (1 - y) * F.logsigmoid(-pred))
        return float(torch.sum(per_row) / n_real)

    def _fit_matrix(self, X, y, eval_xy=None, n_rounds=None):
        n, n_feat = X.shape
        n_bins = self.max_bins
        self._edges = [_quantile_bins(X[:, f], n_bins) for f in range(n_feat)]
        binned = self._to_device(self._bin(X))
        yd = self._to_device(y.astype(np.float32))
        if self.loss == "squared":
            self._base_score = float(np.mean(y))
        else:
            p = min(max(float(np.mean(y)), 1e-6), 1 - 1e-6)
            self._base_score = float(np.log(p / (1 - p)))
        pred = torch.full((n,), self._base_score, dtype=torch.float32,
                          device=self.device)
        if eval_xy is not None:
            eval_binned = self._to_device(self._bin(eval_xy[0]))
            eval_y = self._to_device(eval_xy[1].astype(np.float32))
            eval_pred = torch.full((len(eval_y),), self._base_score,
                                   dtype=torch.float32, device=self.device)

        depth = self.max_depth
        n_nodes_total = 2 ** (depth + 1) - 1
        rounds = int(n_rounds) if n_rounds is not None else self.n_trees
        feat_arr = np.full((rounds, n_nodes_total), -1, dtype=np.int32)
        bin_arr = np.zeros((rounds, n_nodes_total), dtype=np.int32)
        leaf_arr = np.zeros((rounds, n_nodes_total), dtype=np.float32)
        lam = self.reg_lambda
        history = []
        for t in range(rounds):
            if self.loss == "squared":
                grad = pred - yd
                hess = torch.ones_like(pred)
            else:
                p = torch.sigmoid(pred)
                grad = p - yd
                hess = p * (1 - p)
            node_of_row = torch.zeros(n, dtype=torch.int64,
                                      device=self.device)
            active = torch.ones(n, dtype=torch.bool, device=self.device)
            for level in range(depth):
                start, n_level = 2 ** level - 1, 2 ** level
                gsum, hsum = _level_histograms(
                    binned, node_of_row - start, active, grad, hess,
                    n_level, n_feat, n_bins)
                bf, bb, gain = _best_splits(gsum, hsum, lam, n_level)
                # One host copy a level: the tree's split table is built on
                # the host a level at a time, as the JAX package's is.
                # raydp: ignore[R5]
                splits, bf_np, bb_np = torch.stack(
                    [(gain > self.min_split_gain).long(), bf, bb]).cpu().numpy()
                splits = splits.astype(bool)
                feat_arr[t, start:start + n_level] = np.where(
                    splits, bf_np, -1)
                bin_arr[t, start:start + n_level] = np.where(splits, bb_np, 0)
                # Active rows descend one level: bin <= threshold → left.
                node_feat = self._to_device(feat_arr[t]).long()[node_of_row]
                node_bin = self._to_device(bin_arr[t])[node_of_row]
                row_bin = torch.gather(binned, 1,
                                       node_feat.clamp_min(0)[:, None])[:, 0]
                child = torch.where(row_bin <= node_bin, 2 * node_of_row + 1,
                                    2 * node_of_row + 2)
                moved = active & (node_feat >= 0)
                node_of_row = torch.where(moved, child, node_of_row)
                active = moved
            # Leaf value of every node a row stopped in: -G / (H + λ).
            gh = torch.zeros(2, n_nodes_total, dtype=torch.float32,
                             device=self.device)
            gh[0].index_add_(0, node_of_row, grad)
            gh[1].index_add_(0, node_of_row, hess)
            leaf = -gh[0] / (gh[1] + lam)
            leaf_arr[t] = leaf.cpu().numpy()  # raydp: ignore[R5] -- once a tree
            pred = pred + self.learning_rate * leaf[node_of_row]
            # The loss after this round's tree: history[-1] is the final
            # model's.
            entry = {"round": t,
                     "train_loss": self._loss_of(pred, yd, n)}
            if eval_xy is not None:
                eval_node = self._route(eval_binned, feat_arr[t], bin_arr[t])
                eval_pred = eval_pred + self.learning_rate * \
                    self._to_device(leaf_arr[t])[eval_node]
                entry["eval_loss"] = self._loss_of(eval_pred, eval_y,
                                                   len(eval_y))
            history.append(entry)
        self._trees = {"feature": feat_arr, "bin": bin_arr, "leaf": leaf_arr}
        self.history = history
        return history

    def _route(self, binned: torch.Tensor, feat_t: np.ndarray,
               bin_t: np.ndarray) -> torch.Tensor:
        """The node of ONE fitted tree that each row ends in."""
        return _route_tree(binned, self._to_device(feat_t).long(),
                           self._to_device(bin_t), self.max_depth)

    # -- inference ------------------------------------------------------
    def _raw_predict(self, X: np.ndarray) -> np.ndarray:
        binned = self._to_device(self._bin(np.asarray(X, dtype=np.float32)))
        feat = self._to_device(self._trees["feature"]).long()
        bins = self._to_device(self._trees["bin"])
        leaf = self._to_device(self._trees["leaf"])
        out = torch.zeros(binned.shape[0], dtype=torch.float32,
                          device=self.device)
        for t in range(feat.shape[0]):
            out += leaf[t][_route_tree(binned, feat[t], bins[t],
                                       self.max_depth)]
        raw = self._base_score + self.learning_rate * out
        return raw.cpu().numpy()

    def predict(self, X) -> np.ndarray:
        raw = self._raw_predict(np.asarray(X))
        if self.loss == "logistic":
            return 1.0 / (1.0 + np.exp(-raw))
        return raw

    def predict_on_ds(self, ds) -> np.ndarray:
        """Predictions over a dataset's feature columns: exactly
        ``ds.total_rows`` of them, in dataset order. A shard plan pads each
        rank to ``ceil(total / num_shards)`` rows; the padded rows land on
        the rows they repeat (``MLDataset.shard_global_indices``)."""
        flat = self.predict(self._matrix_from_ds(ds, with_label=False))
        idx = np.concatenate([ds.shard_global_indices(r)
                              for r in range(ds.num_shards)])
        out = np.empty((ds.total_rows,) + flat.shape[1:], dtype=flat.dtype)
        out[idx] = flat
        return out

    def evaluate(self, ds) -> dict:
        X, y = self._matrix_from_ds(ds)
        pred = self.predict(X)
        if self.loss == "logistic":
            return {"accuracy": float(np.mean((pred > 0.5) == (y > 0.5)))}
        mse = float(np.mean((pred - y) ** 2))
        return {"mse": mse, "rmse": float(np.sqrt(mse))}

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> str:
        if self._trees is None:
            raise ValueError("cannot save an unfitted GBTEstimator")
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "trees.npz"),
            feature=self._trees["feature"], bin=self._trees["bin"],
            leaf=self._trees["leaf"],
            **{f"edges_{i}": e for i, e in enumerate(self._edges)},
        )
        meta = {
            "n_trees": self.n_trees,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "reg_lambda": self.reg_lambda,
            "max_bins": self.max_bins,
            "loss": self.loss,
            "min_split_gain": self.min_split_gain,
            "base_score": self._base_score,
            "n_features": len(self._edges),
            "feature_columns": self.feature_columns,
            "label_column": self.label_column,
        }
        with open(os.path.join(path, "gbt.json"), "w") as f:
            json.dump(meta, f)
        return path

    @classmethod
    def restore(cls, path: str,
                device: DeviceLike = "cuda") -> "GBTEstimator":
        with open(os.path.join(path, "gbt.json")) as f:
            meta = json.load(f)
        est = cls(
            n_trees=meta["n_trees"], max_depth=meta["max_depth"],
            learning_rate=meta["learning_rate"],
            reg_lambda=meta["reg_lambda"], max_bins=meta["max_bins"],
            loss=meta["loss"],
            min_split_gain=meta.get("min_split_gain", 0.0),
            feature_columns=meta["feature_columns"],
            label_column=meta["label_column"], device=device,
        )
        data = np.load(os.path.join(path, "trees.npz"))
        est._trees = {"feature": data["feature"], "bin": data["bin"],
                      "leaf": data["leaf"]}
        est._edges = [data[f"edges_{i}"] for i in range(meta["n_features"])]
        est._base_score = meta["base_score"]
        return est
