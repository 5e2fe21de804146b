"""Learning-to-rank objectives and metrics of the port.

Counterpart of ``lightgbm_tpu/ranking.py``: ``LambdarankNDCG`` (LambdaMART
gradients with NDCG delta weights, truncation, ``lambdarank_norm`` and
position-debiased scores), ``RankXENDCG`` and the NDCG@k and MAP@k
metrics: plain functions (``ndcg_at_k``, ``map_at_k``) and the metric
objects evaluation during training builds over them (``NDCGMetric``,
``MapMetric``, one per ``eval_at`` position).

Query buckets. The JAX package pads every query to the longest one (Q)
and computes the pairwise lambdas of blocks of ``2**25 // Q**2`` queries
as ``[blk, Q, Q]`` tensors. With a few long queries among many short
ones (MSLR-WEB30K: ~120 documents on average, up to ~1,251) most of
those pair slots are padding. Here every query is padded only to the
power of two at or above its own size, the queries of one padded size
form a bucket, and each bucket is processed in blocks of
``2**25 // P**2`` queries of its size P: the same per-query arithmetic,
with padded slots masked exactly as in JAX. Only the float summation
order of the per-document and per-query sums may differ from JAX's.

Sort order. At equal scores (every query at iteration 0) a document's
rank comes from the tie order of the sort: JAX sorts ``-s`` ascending
with a stable sort, padded slots at ``-inf`` (so last). The port does the
same (negate, then ``torch.argsort(..., stable=True)``), so the ranks are
the same.

Weights multiply the per-row lambdas and hessians after the query loop,
as in the JAX package (LightGBM weights whole queries).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .metrics import Metric
from .objectives import Objective
from .obs.jit_tracker import register_jit

__all__ = ["QueryBucket", "LambdarankNDCG", "RankXENDCG",
           "create_ranking_objective", "ndcg_at_k", "map_at_k",
           "NDCGMetric", "MapMetric", "create_ranking_metric"]

# elements of one block's [blk, P, P] pair tensors (the JAX package's
# target_elems)
PAIR_BUDGET = 1 << 25


def _label_gains(label_gain: Sequence[float], max_label: int) -> np.ndarray:
    """The gain of each relevance label: ``label_gain`` when given, else
    ``2**label - 1``."""
    if label_gain:
        g = np.asarray(label_gain, np.float64)
        if len(g) <= max_label:
            raise ValueError("label_gain shorter than max label")
        return g
    return (2.0 ** np.arange(max_label + 1)) - 1.0


class QueryBucket(NamedTuple):
    """The queries padded to one power-of-two size ``P``, in query
    order."""
    P: int
    qids: torch.Tensor   # [nb] int64 query numbers
    idx: torch.Tensor    # [nb, P] int64 row of each slot (0 when padded)
    mask: torch.Tensor   # [nb, P] bool, real slots
    slots: torch.Tensor  # flat positions of the real slots in [nb * P]
    rows: torch.Tensor   # the row of each real slot (idx at slots)
    blk: int             # queries per block of [blk, P, P] pair tensors

    def real(self, x: torch.Tensor) -> torch.Tensor:
        """The real slots of a ``[nb, P]`` tensor, in the order of
        ``rows`` (a gather: no read-back of the mask's count)."""
        return x.reshape(-1)[self.slots]


def _pad_queries(query_boundaries: np.ndarray, device,
                 budget: int = PAIR_BUDGET) -> List[QueryBucket]:
    """The queries of ``query_boundaries`` (int64 ``[nq + 1]``) grouped
    by the power of two at or above their size, smallest first."""
    qb = np.asarray(query_boundaries, np.int64)
    sizes = np.diff(qb)
    pad = np.ones_like(sizes)
    big = sizes > 1
    pad[big] = 1 << np.ceil(np.log2(sizes[big])).astype(np.int64)
    out = []
    for P in np.unique(pad):
        P = int(P)
        qs = np.nonzero(pad == P)[0]
        slot = np.arange(P)[None, :]
        mask = slot < sizes[qs][:, None]
        idx = np.where(mask, qb[qs][:, None] + slot, 0)
        slots = np.flatnonzero(mask)

        def dev(a):
            return torch.as_tensor(a, device=device)
        out.append(QueryBucket(
            P, dev(qs), dev(idx), dev(mask), dev(slots),
            dev(idx.reshape(-1)[slots]),
            max(1, min(len(qs), budget // (P * P)))))
    return out


def _ranks_desc(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of item i when sorted by score descending
    (0-based, ties in slot order); padded items rank last."""
    s = torch.where(mask, scores, -torch.inf)
    order = torch.argsort(-s, dim=-1, stable=True)
    put = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            put.expand_as(order))


def _inverse_max_dcg(gains: torch.Tensor, mask: torch.Tensor,
                     k: int) -> torch.Tensor:
    """1 / maxDCG@k per query (0 when the query has no gain)."""
    g = torch.where(mask, gains, -torch.inf)
    g_sorted = -torch.sort(-g, dim=-1).values
    pos = torch.arange(g.shape[-1], device=g.device)
    disc = 1.0 / torch.log2(2.0 + pos.to(g.dtype))
    use = (pos[None, :] < k) & torch.isfinite(g_sorted)
    dcg = torch.where(use, g_sorted * disc[None, :], 0.0).sum(dim=-1)
    return torch.where(dcg > 0, 1.0 / dcg, 0.0)


def _block_lambdas(s_rows, mask, gains, inv, sigma, trunc, norm):
    """The lambdas and hessians of a block of queries, ``[blk, P]``
    each, from their scores, masks, gains and inverse max DCGs."""
    s = torch.where(mask, s_rows, -torch.inf)
    ranks = _ranks_desc(s, mask)
    disc = torch.where(mask, 1.0 / torch.log2(2.0 + ranks.to(s.dtype)),
                       0.0)
    # pairwise tensors [blk, P, P]: i (dim 1) against j (dim 2)
    sd = torch.where(mask, s_rows, 0.0)
    s_diff = sd[:, :, None] - sd[:, None, :]
    g_diff = gains[:, :, None] - gains[:, None, :]
    d_diff = disc[:, :, None] - disc[:, None, :]
    # truncation: at least one of the pair inside the top k
    in_top = ranks < trunc
    pair_m = (mask[:, :, None] & mask[:, None, :] & (g_diff > 0)
              & (in_top[:, :, None] | in_top[:, None, :]))
    delta = g_diff.abs() * d_diff.abs() * inv[:, None, None]
    p = torch.sigmoid(-(sigma * s_diff))       # 1 / (1 + e^(sigma diff))
    lam = torch.where(pair_m, -sigma * p * delta, 0.0)
    hess = torch.where(pair_m, sigma * sigma * p * (1.0 - p) * delta, 0.0)
    # i is the better document of the pair (i, j): lambda_i += lam
    g_q = lam.sum(dim=2) - lam.sum(dim=1)
    h_q = hess.sum(dim=2) + hess.sum(dim=1)
    if norm:
        sum_lam = lam.abs().sum(dim=(1, 2)) + 1e-20
        norm_f = torch.where(sum_lam > 0,
                             torch.log2(1.0 + sum_lam) / sum_lam, 1.0)
        g_q = g_q * norm_f[:, None]
        h_q = h_q * norm_f[:, None]
    return g_q, h_q


def _lambdarank_grads(score: torch.Tensor, buckets: List[QueryBucket],
                      gain_of_row: torch.Tensor,
                      weight: Optional[torch.Tensor], sigma: float,
                      trunc: int, norm: bool):
    """LambdaMART lambdas and hessians ``[n]`` of float32 scores ``[n]``
    over the query buckets of :func:`_pad_queries`."""
    g = torch.zeros_like(score)
    h = torch.zeros_like(score)
    for b in buckets:
        gains = torch.where(b.mask, gain_of_row[b.idx], 0.0)
        inv = _inverse_max_dcg(gains, b.mask, trunc)
        s_rows = score[b.idx]
        gq, hq = [], []
        for lo in range(0, len(b.qids), b.blk):
            hi = lo + b.blk
            out = _block_lambdas(s_rows[lo:hi], b.mask[lo:hi],
                                 gains[lo:hi], inv[lo:hi], sigma, trunc,
                                 norm)
            gq.append(out[0])
            hq.append(out[1])
        # every row sits in exactly one slot
        g[b.rows] = b.real(torch.cat(gq))
        h[b.rows] = b.real(torch.cat(hq))
    if weight is not None:
        g = g * weight
        h = h * weight
    return g, h


_lambdarank_grads = register_jit("ranking/lambdarank_grads",
                                 _lambdarank_grads, max_signatures=8)


class LambdarankNDCG(Objective):
    """LambdaMART gradients with NDCG delta weighting."""

    name = "lambdarank"
    is_ranking = True

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.sigmoid = cfg.sigmoid
        self.trunc = cfg.lambdarank_truncation_level
        self.norm = cfg.lambdarank_norm
        self.num_pos = 0
        self._ready = False

    def set_dataset(self, dataset) -> None:
        qb = dataset.query_boundaries()
        if qb is None:
            raise ValueError(
                "lambdarank requires query information (group)")
        dev = dataset.device
        self.buckets = _pad_queries(qb, dev)
        label = np.asarray(dataset.get_label())
        gains_tbl = _label_gains(self.cfg.label_gain, int(label.max()))
        self.gain_of_row = torch.as_tensor(
            gains_tbl[label.astype(np.int64)], dtype=torch.float32,
            device=dev)
        # position-debiased learning to rank: raw positions factorized to
        # ids; the biases start at 0 and take a Newton step each iteration
        pos = dataset.get_position()
        if pos is not None:
            uniq, inverse = np.unique(np.asarray(pos), return_inverse=True)
            self.num_pos = int(len(uniq))
            self.pos_ids = torch.as_tensor(inverse.astype(np.int64),
                                           device=dev)
            self.pos_biases = torch.zeros((self.num_pos,),
                                          dtype=torch.float32, device=dev)
        self._ready = True

    def _update_position_biases(self, g, h):
        """One Newton-Raphson step on the per-position bias factors."""
        reg = self.cfg.lambdarank_position_bias_regularization
        lr = self.cfg.learning_rate

        def seg(x):
            return torch.zeros((self.num_pos,), dtype=x.dtype,
                               device=x.device).index_add_(0, self.pos_ids,
                                                           x)
        cnt = seg(torch.ones_like(g))
        fd = -seg(g) - self.pos_biases * reg * cnt
        sd = -seg(h) - reg * cnt
        self.pos_biases = self.pos_biases + lr * fd / (sd.abs() + 0.001)

    def grad_hess(self, score, label, weight):
        assert self._ready, "set_dataset must be called first"
        if self.num_pos:
            # lambdas against the position-bias-adjusted scores
            score = score + self.pos_biases[self.pos_ids]
        g, h = _lambdarank_grads(score, self.buckets, self.gain_of_row,
                                 weight, self.sigmoid, self.trunc,
                                 self.norm)
        # the bias update sees the weighted lambdas
        if self.num_pos:
            self._update_position_biases(g, h)
        return g, h


class RankXENDCG(Objective):
    """The cross-entropy NDCG surrogate (XE-NDCG-MART).

    The JAX package perturbs the target gains by ``exp(gumbel * 0.0)``,
    which is exactly 1 for every finite Gumbel draw, so the draw has no
    effect; the port computes the same function without drawing."""

    name = "rank_xendcg"
    is_ranking = True

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._ready = False

    def set_dataset(self, dataset) -> None:
        qb = dataset.query_boundaries()
        if qb is None:
            raise ValueError("rank_xendcg requires query information")
        self.buckets = _pad_queries(qb, dataset.device)
        self._ready = True

    def grad_hess(self, score, label, weight):
        assert self._ready
        g = torch.zeros_like(score)
        h = torch.zeros_like(score)
        for b in self.buckets:
            phi = torch.where(b.mask, torch.pow(2.0, label[b.idx]) - 1.0,
                              0.0)
            phi = phi / phi.sum(dim=1, keepdim=True).clamp_min(1e-20)
            s = torch.where(b.mask, score[b.idx], -torch.inf)
            rho = torch.where(b.mask, torch.softmax(s, dim=1), 0.0)
            g[b.rows] = b.real(rho - phi)
            h[b.rows] = b.real((rho * (1.0 - rho)).clamp_min(1e-20))
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h


def create_ranking_objective(cfg: Config) -> Objective:
    if cfg.objective == "lambdarank":
        return LambdarankNDCG(cfg)
    if cfg.objective == "rank_xendcg":
        return RankXENDCG(cfg)
    raise ValueError(cfg.objective)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _per_query(score, label, query_boundaries, fn) -> float:
    """The mean over queries of ``fn(bucket, scores, labels)`` (one
    float32 value per query of the bucket)."""
    out = torch.zeros((len(query_boundaries) - 1,), dtype=torch.float32,
                      device=score.device)
    for b in _pad_queries(query_boundaries, score.device):
        s = torch.where(b.mask, score[b.idx].to(torch.float32), -torch.inf)
        out[b.qids] = fn(b, s, label[b.idx])
    return float(out.mean())


def ndcg_at_k(score: torch.Tensor, label: torch.Tensor,
              query_boundaries: np.ndarray, k: int,
              label_gain: Sequence[float] = ()) -> float:
    """NDCG@k averaged over the queries (a query without gain counts 1),
    as the JAX package's ``NDCGMetric``."""
    tbl = torch.as_tensor(
        _label_gains(label_gain, int(label.max())), dtype=torch.float32,
        device=score.device)

    def fn(b, s, lab):
        gains = torch.where(b.mask, tbl[lab.to(torch.int64)], 0.0)
        order = torch.argsort(-s, dim=1, stable=True)
        g_sorted = gains.gather(1, order)
        m_sorted = b.mask.gather(1, order)
        pos = torch.arange(b.P, device=s.device)
        disc = 1.0 / torch.log2(2.0 + pos.to(torch.float32))
        use = (pos[None, :] < k) & m_sorted
        dcg = torch.where(use, g_sorted * disc[None, :], 0.0).sum(dim=1)
        inv_max = _inverse_max_dcg(gains, b.mask, k)
        return torch.where(inv_max > 0, dcg * inv_max, 1.0)
    return _per_query(score, label, query_boundaries, fn)


def map_at_k(score: torch.Tensor, label: torch.Tensor,
             query_boundaries: np.ndarray, k: int) -> float:
    """MAP@k averaged over the queries (a query without a relevant
    document counts 1), as the JAX package's ``MapMetric``."""
    def fn(b, s, lab):
        rel = torch.where(b.mask, (lab > 0).to(torch.float32), 0.0)
        order = torch.argsort(-s, dim=1, stable=True)
        rel_sorted = rel.gather(1, order)
        pos = torch.arange(b.P, device=s.device)
        prec = rel_sorted.cumsum(dim=1) / (1.0 + pos.to(torch.float32))
        use = pos[None, :] < k
        ap_num = torch.where(use, prec * rel_sorted, 0.0).sum(dim=1)
        denom = rel.sum(dim=1).clamp_max(float(k))
        return torch.where(denom > 0, ap_num / denom, 1.0)
    return _per_query(score, label, query_boundaries, fn)


class NDCGMetric(Metric):
    """NDCG@k over a dataset's queries (weights are not read, as in the
    JAX package)."""

    higher_better = True

    def __init__(self, cfg: Config, k: int):
        super().__init__(cfg)
        self.k = k
        self.name = f"ndcg@{k}"

    def eval_with_query(self, raw_score, label, weight, dataset, convert_fn):
        qb = dataset.query_boundaries()
        if qb is None:
            raise ValueError("NDCG requires query information")
        score = raw_score[0] if raw_score.dim() == 2 else raw_score
        return ndcg_at_k(score, label, qb, self.k, self.cfg.label_gain)


class MapMetric(Metric):
    """MAP@k over a dataset's queries."""

    higher_better = True

    def __init__(self, cfg: Config, k: int):
        super().__init__(cfg)
        self.k = k
        self.name = f"map@{k}"

    def eval_with_query(self, raw_score, label, weight, dataset, convert_fn):
        qb = dataset.query_boundaries()
        if qb is None:
            raise ValueError("MAP requires query information")
        score = raw_score[0] if raw_score.dim() == 2 else raw_score
        return map_at_k(score, label, qb, self.k)


def create_ranking_metric(kind: str, cfg: Config) -> List[Metric]:
    """One metric object per ``eval_at`` position."""
    ks = cfg.eval_at or [1, 2, 3, 4, 5]
    if kind == "ndcg":
        return [NDCGMetric(cfg, k) for k in ks]
    return [MapMetric(cfg, k) for k in ks]
