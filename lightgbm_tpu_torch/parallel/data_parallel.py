"""The grower's side of a world: data-, feature- and voting-parallel
tree growth (the JAX package's ``parallel/data_parallel.py`` and the
distributed branches of its ``ops/grow.py``).

The JAX package runs its grower inside ``shard_map`` and lets XLA emit
the ``psum``s; the port's grower (``ops/grow.py`` ``Grower``) takes a
:class:`DistGrow` and calls it at the same points:

- ``data``: rows are sharded. K1 builds the rank's histogram of a window
  and :meth:`DistGrow.reduce_hist` allreduces it before it is stored or
  subtracted (f32, or int8/int16 block-quantized with an error-feedback
  residual, ``parallel/comms.py``; exact int32 under quantized
  gradients). The root totals, the in-bag counts and the children's left
  counts are summed over the world (:meth:`sum`), the quantization
  scales are the world's maxima (:meth:`max`). Every rank then searches
  the same histograms and takes the same split.
- ``data`` with ``split_search="sharded"``: the histograms are
  reduce-scattered instead, each rank keeps and searches only its
  ``ceil(F / D)`` features, and the best split records are combined
  (:meth:`combine`, the reference's SyncUpGlobalBestSplit).
- ``feature``: rows are replicated, every rank's histogram is the global
  one, each rank searches the features it owns and the records are
  combined.
- ``voting`` (PV-Tree): rows are sharded and the histogram cache stays
  local. Each rank elects its top ``top_k`` features from a search of its
  local histograms (local totals, ``min_data_in_leaf`` and
  ``min_sum_hessian_in_leaf`` over the world's size), the ballots are
  summed, the ``2 * top_k`` most voted features win (ties to the lower
  feature) and only their histograms are reduced (:meth:`elect`).

Every rank issues the same collectives in the same order: the branches
above depend only on the configuration and on values every rank holds
identically (the split records, the counts that come from them).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comms

__all__ = ["DistGrow", "combine_split_infos"]

# the split record's columns the combine reads (ops/split.py FIELDS)
_GAIN, _FEATURE = 0, 1


def combine_split_infos(comm, rec: torch.Tensor,
                        masks: Optional[torch.Tensor] = None):
    """SyncUpGlobalBestSplit: every rank's ``[S, NF]`` records (and
    ``[S, B]`` categorical masks) gathered in one ``all_gather``; each
    leaf takes the record of greatest gain, ties to the lower feature id
    (the JAX ``_combine_split_infos``). With disjoint feature ownership
    one rank wins, and its record is taken bit for bit."""
    S, NF = rec.shape
    packed = rec if masks is None \
        else torch.cat([rec, masks.to(rec.dtype)], dim=1)
    g = comm.all_gather(packed)                       # [D, S, NF (+ B)]
    gain = g[:, :, _GAIN]
    gmax = gain.amax(dim=0)
    at_max = gain >= gmax[None]
    feat = torch.where(at_max, g[:, :, _FEATURE],
                       torch.full_like(gain, float(2 ** 30)))
    win = at_max & (feat == feat.amin(dim=0)[None])
    src = win.to(torch.int8).argmax(dim=0)            # first winning rank
    pick = g[src, torch.arange(S, device=g.device)]   # [S, NF (+ B)]
    if masks is None:
        return pick
    return pick[:, :NF].contiguous(), pick[:, NF:] > 0.5


class DistGrow:
    """The world's side of one grower (see the module docstring).

    ``mode``: ``data``, ``feature`` or ``voting``; ``split_search``
    ``sharded`` applies to ``data``; ``hist_comm`` is the resolved wire
    format; ``C`` the histogram's columns (features, or bundle columns).
    """

    def __init__(self, comm, mode: str, C: int, hist_comm: str = "f32",
                 split_search: str = "gathered", top_k: int = 20,
                 quantized: bool = False):
        self.comm = comm
        self.mode = mode
        self.D, self.rank = comm.size, comm.rank
        self.fp = mode == "feature"
        self.vp = mode == "voting"
        self.sharded = mode == "data" and split_search == "sharded"
        self.top_k = int(top_k)
        self.C = C
        # the wire quantizes only where a full histogram is reduced:
        # data-parallel float histograms
        self.qm, self.use_ef, self._psum_ef = comms.make_hist_psum_ef(
            comm, hist_comm, quantize=not (self.fp or self.vp or quantized))
        # the voting exchange quantizes under hist_comm too (stateless,
        # shared scales); integer histograms stay exact
        self.vote_comm = hist_comm if self.vp and not quantized else "f32"
        # sharded search and feature ownership: ceil(C / D) columns each
        self.Cl = -(-C // self.D)
        self.Csp = self.Cl * self.D
        self.c_start = self.rank * self.Cl

    # -- scalars ---------------------------------------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The world's sum of a rank's partial (identity under
        ``feature``, whose rows are replicated)."""
        if self.fp:
            return t
        return self.comm.all_reduce(t.clone())

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if self.fp:
            return t
        return self.comm.all_reduce(t.clone(), "max")

    # -- histograms ------------------------------------------------------
    def cache_columns(self) -> int:
        """Columns of a cached histogram: the owned chunk when sharded."""
        return self.Cl if self.sharded else self.C

    def pad_columns(self, x: torch.Tensor) -> torch.Tensor:
        """Pad the column axis (third from last) to ``D * ceil(C / D)``."""
        if self.Csp == x.shape[-3]:
            return x
        pw = [0, 0, 0, 0, 0, self.Csp - x.shape[-3]]
        return torch.nn.functional.pad(x, pw)

    def reduce_hist(self, x: torch.Tensor, ef: Optional[torch.Tensor]):
        """The histogram a rank stores from its local one: allreduced
        (with the error feedback), this rank's reduce-scattered chunk, or
        the local one (feature, voting). Returns ``(hist, ef)``."""
        if self.fp or self.vp:
            return x, ef
        if self.sharded:
            xp = self.pad_columns(x)
            ax = xp.dim() - 3
            if not self.use_ef:
                return comms.hist_reduce_scatter(self.comm, xp, "f32",
                                                 scatter_axis=ax), ef
            return comms.hist_reduce_scatter(self.comm, xp, self.qm, ef, ax)
        return self._psum_ef(x, ef)

    def reduce_hist_once(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`reduce_hist` without the error feedback (a histogram
        recomputed after a pool miss)."""
        if self.fp or self.vp:
            return x
        if self.sharded:
            xp = self.pad_columns(x)
            return comms.hist_reduce_scatter(self.comm, xp, self.qm,
                                             scatter_axis=xp.dim() - 3)
        return comms.hist_allreduce(self.comm, x, self.qm)

    def ef_shape(self, B: int):
        """Shape of the error-feedback residual (None: no residual)."""
        if not self.use_ef:
            return None
        return (self.Csp if self.sharded else self.C, B, 2)

    def full_from_chunk(self, chunk: torch.Tensor) -> torch.Tensor:
        """The global ``[.., C, B, 2]`` histogram from every rank's owned
        chunk (one ``all_gather``; forced splits under the sharded
        search)."""
        g = self.comm.all_gather(chunk.contiguous())  # [D, .., Cl, B, 2]
        g = torch.movedim(g, 0, -4)
        full = g.reshape(g.shape[:-4] + (self.Csp,) + g.shape[-2:])
        return full[..., :self.C, :, :]

    def chunk_totals(self, chunk_f: torch.Tensor) -> torch.Tensor:
        """``[S, 2]`` leaf totals from float chunks ``[S, Cl, B, 2]``:
        rank 0 owns column 0, every row of which sums to the leaf's
        total; one ``[S, 2]`` allreduce hands them to every rank."""
        t = chunk_f[:, 0].sum(dim=1)
        if self.rank != 0:
            t = torch.zeros_like(t)
        return self.comm.all_reduce(t.contiguous())

    # -- the search ------------------------------------------------------
    def owned(self, device) -> torch.Tensor:
        """``[C]`` bool: the columns this rank searches (feature mode)."""
        c = torch.arange(self.C, device=device)
        return torch.clamp_max(c // self.Cl, self.D - 1) == self.rank

    def chunk_slice(self, v: torch.Tensor, fill) -> torch.Tensor:
        """This rank's ``Cl`` slice of a per-column vector (last axis),
        padded to ``D * Cl`` with ``fill``."""
        if v is None:
            return None
        if self.Csp > v.shape[-1]:
            pad = torch.full(v.shape[:-1] + (self.Csp - v.shape[-1],), fill,
                             dtype=v.dtype, device=v.device)
            v = torch.cat([v, pad], dim=-1)
        return v[..., self.c_start:self.c_start + self.Cl]

    def combine(self, rec: torch.Tensor, masks=None):
        return combine_split_infos(self.comm, rec, masks)

    def elect(self, fgains: torch.Tensor) -> torch.Tensor:
        """PV-Tree's election from the local per-column gains ``[S, C]``:
        each rank's ballot is its top ``top_k`` finite columns, the
        ballots are summed, and the ``2 * top_k`` most voted columns win,
        ties to the lower column. Returns the elected indices
        ``[S, k2]``."""
        S, C = fgains.shape
        k = min(self.top_k, C)
        kth = torch.sort(fgains, dim=1).values[:, C - k]
        ballot = torch.isfinite(fgains) & (fgains >= kth[:, None])
        votes = self.comm.all_reduce(ballot.to(torch.int32))
        k2 = min(2 * self.top_k, C)
        ar = torch.arange(C, device=fgains.device)
        score = votes.to(torch.int64) * C + (C - 1 - ar)[None]
        return torch.topk(score, k2, dim=1).indices

    def exchange_elected(self, hist: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
        """The global histograms of the elected columns only: the
        ``[S, k2, B, 2]`` selection is reduced and scattered back into a
        zero ``[S, C, B, 2]``."""
        S, C, B, _ = hist.shape
        ix = idx[:, :, None, None].expand(-1, -1, B, 2)
        sel = torch.gather(hist, 1, ix).contiguous()
        gsel = comms.hist_allreduce(self.comm, sel, self.vote_comm,
                                    strategy="psum")
        return torch.zeros_like(hist).scatter_(1, ix, gsel)
