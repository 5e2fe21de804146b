"""Exclusive Feature Bundling (EFB): the plan on the host, the bundled
bin matrix on the device.

A copy of ``lightgbm_tpu/ops/bundling.py`` (``BundleInfo``,
``_eligible``, ``build_bundles``), which the port may not import. The
greedy first-fit, the group consolidation, the ``RandomState(seed)``
sample of ``sample_rows`` rows and the conflict budget are the same
code, so the groups and every table equal the JAX package's.

Bundle layout (the JAX package's):

- position 0 of a multi-member bundle is "every member at its bin 0";
- member ``j`` with ``nb`` bins occupies positions ``[off, off + nb -
  2]``, holding its bins ``1 .. nb - 1``; a conflict row (two members
  nonzero) keeps the later member's value;
- a singleton ("direct") bundle stores its feature's bins verbatim;
- a member's bin-0 statistics are reconstructed at search time as the
  leaf total less the member's range (``ops/split.py``
  ``find_best_split_bundled``).

What differs from the JAX module is where the work runs. The plan reads
only the sampled rows, copied to the host from the bin tensor (on the
device in training). The bundled ``[n, G]`` matrix is built on the bin
tensor's device (:func:`bundle_columns`), a block of rows at a time, in
one scatter-max per block, never as a host loop over the full matrix;
:func:`bundle_columns_np` is the JAX package's numpy loop, the plain
version it is held to.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .binning import BinType, MissingType

__all__ = ["BundleInfo", "build_bundles", "bundle_columns",
           "bundle_columns_np"]

# per-bundle conflict budget as a fraction of sampled rows
# (single_val_max_conflict_cnt = total_sample_cnt / 10000)
MAX_CONFLICT_FRACTION = 1.0 / 10000
# elements of one block of rows in bundle_columns
_BLOCK_ELEMS = 1 << 24


class BundleInfo(NamedTuple):
    """The bundling plan and the bundled matrix handed to the grower."""
    groups: List[List[int]]       # member feature ids per bundle
    bundle_of: np.ndarray         # [F] i32 — feature -> bundle
    offset_of: np.ndarray         # [F] i32 — feature -> first position
                                  #   of bin 1 inside its bundle
    is_direct: np.ndarray         # [F] bool — singleton stored verbatim
    bins_bundled: torch.Tensor    # [n, G] u8/u16 bundle columns, on the
                                  #   device of the bins they came from
    num_positions: int            # B: max positions over bundles
    member_at: np.ndarray         # [G, B] i32 — candidate position ->
                                  #   member feature id (-1: none)
    tloc_at: np.ndarray           # [G, B] i32 — position -> member-local
                                  #   threshold bin
    end_at: np.ndarray            # [G, B] i32 — flat [G*B] index of the
                                  #   member's last position (range end)
    nanpos_at: np.ndarray         # [G, B] i32 — flat [G*B] index of the
                                  #   member-at-position's NaN-bin
                                  #   position (-1: member has none)
    nan_at: np.ndarray            # [G, B] bool — position IS a member's
                                  #   NaN bin (excluded from scans)


def _eligible(mappers, F: int, max_cat_onehot: int = 4) -> np.ndarray:
    """Features that may enter a multi-member bundle: numerical ones
    whose zero maps to bin 0 (MissingType.ZERO ones stay direct: their
    missing bin is the shared position 0), and categorical ones in the
    one-hot regime (their bin 0 is their most frequent category)."""
    ok = np.zeros(F, bool)
    for j, m in enumerate(mappers):
        if m.num_bins < 2:
            continue
        if m.bin_type == BinType.CATEGORICAL:
            ok[j] = m.num_bins <= max_cat_onehot
            continue
        if m.missing_type == MissingType.ZERO:
            continue
        if int(m.value_to_bin(np.zeros(1))[0]) != 0:
            continue
        ok[j] = True
    return ok


def _host_rows(bins: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """``bins[idx]`` as a host numpy array (uint16 moved as its int16
    bits: CUDA gathers and numpy conversion of uint16 are missing)."""
    wide = bins.dtype == torch.uint16
    src = bins.view(torch.int16) if wide else bins
    rows = src.index_select(0, torch.as_tensor(idx, device=bins.device))
    out = rows.cpu().numpy()
    return out.view(np.uint16) if wide else out


def build_bundles(bins, mappers, max_positions: int = 255,
                  sample_rows: int = 200_000,
                  sparse_threshold: float = 0.8, seed: int = 0,
                  max_cat_onehot: int = 4) -> Optional[BundleInfo]:
    """Greedy bundling over the ``[n, F]`` bin matrix ``bins`` (a torch
    tensor on any device, or a numpy array, read as a CPU tensor).
    Returns None when bundling would not reduce the column count.

    Merges tolerate up to ``S * MAX_CONFLICT_FRACTION`` conflicting
    sampled rows per bundle; with zero conflicts the bundled model is
    exactly the unbundled one, split for split. ``max_positions`` caps a
    bundle's positions; a feature joins a bundle only if at least
    ``sparse_threshold`` of its sampled rows sit in its bin 0."""
    if isinstance(bins, np.ndarray):
        bins = torch.from_numpy(bins)
    n, F = bins.shape
    if F < 3:
        return None
    rs = np.random.RandomState(seed)
    idx = rs.choice(n, size=min(n, sample_rows), replace=False) \
        if n > sample_rows else np.arange(n)
    # feature-major, bit-packed nonzero masks of the sampled rows (the
    # greedy loop reads per-feature vectors thousands of times)
    nzT = np.ascontiguousarray((_host_rows(bins, idx) != 0).T)  # [F, S]
    density = nzT.mean(axis=1)
    eligible = _eligible(mappers, F, max_cat_onehot) \
        & (density <= 1 - sparse_threshold)
    S = nzT.shape[1]
    nzP = np.packbits(nzT, axis=1)                   # [F, ceil(S/8)] u8
    del nzT

    nbins = np.array([m.num_bins for m in mappers], np.int64)
    is_cat = np.array([m.bin_type == BinType.CATEGORICAL
                       for m in mappers], bool)
    # a categorical member reserves one extra position: its last
    # category's one-hot candidate is a real split
    member_width = nbins - 1 + is_cat.astype(np.int64)
    conflict_budget = int(S * MAX_CONFLICT_FRACTION)
    popcounts = np.bitwise_count(nzP).sum(axis=1)
    order = np.argsort(-popcounts)          # dense first
    groups: List[List[int]] = []
    group_nz: List[np.ndarray] = []         # aggregated nonzero masks
    group_pos: List[int] = []               # occupied positions (1 + ...)
    group_conf: List[int] = []              # conflicts spent so far
    for j in order:
        if not eligible[j]:
            continue
        placed = False
        width = int(member_width[j])
        nz_j = nzP[j]
        # first fit over all groups, zero-conflict placements first
        cnts = []
        for gi in range(len(groups)):
            if group_pos[gi] + width > max_positions:
                cnts.append(None)
                continue
            cnt = int(np.bitwise_count(group_nz[gi] & nz_j).sum())
            cnts.append(cnt)
            if cnt == 0:
                placed = True
                break
        if not placed:
            for gi, cnt in enumerate(cnts):
                if cnt is not None and \
                        group_conf[gi] + cnt <= conflict_budget:
                    placed = True
                    break
        if placed:
            groups[gi].append(int(j))
            group_nz[gi] |= nz_j
            group_pos[gi] += width
            group_conf[gi] += (cnt if cnt else 0)
        if not placed and width + 1 <= max_positions:
            groups.append([int(j)])
            group_nz.append(nz_j.copy())
            group_pos.append(1 + width)
            group_conf.append(0)

    # consolidation: merge whole groups by their aggregated masks, again
    # zero-conflict placements first; merged groups share position 0
    cons: List[List[int]] = []
    cons_nz: List[np.ndarray] = []
    cons_pos: List[int] = []
    cons_conf: List[int] = []
    for g, gnz, gpos, gconf in zip(groups, group_nz, group_pos,
                                   group_conf):
        placed = False
        cnts2 = []
        for ci in range(len(cons)):
            if cons_pos[ci] + gpos - 1 > max_positions:
                cnts2.append(None)
                continue
            cnt = int(np.bitwise_count(cons_nz[ci] & gnz).sum())
            cnts2.append(cnt)
            if cnt == 0 and cons_conf[ci] + gconf <= conflict_budget:
                placed = True
                break
        if not placed:
            for ci, cnt in enumerate(cnts2):
                if cnt is not None and \
                        cons_conf[ci] + gconf + cnt <= conflict_budget:
                    placed = True
                    break
        if placed:
            cons[ci].extend(g)
            cons_nz[ci] |= gnz
            cons_pos[ci] += gpos - 1
            cons_conf[ci] += gconf + (cnt if cnt else 0)
        else:
            cons.append(list(g))
            cons_nz.append(gnz.copy())
            cons_pos.append(gpos)
            cons_conf.append(gconf)
    groups = cons

    multi = [g for g in groups if len(g) > 1]
    if not multi:
        return None
    bundled_members = {j for g in multi for j in g}
    # singletons: everything else, stored verbatim ("direct" layout)
    final_groups = multi + [[j] for j in range(F)
                            if j not in bundled_members]
    G = len(final_groups)
    if G >= F:
        return None

    bundle_of = np.zeros(F, np.int32)
    offset_of = np.zeros(F, np.int32)
    is_direct = np.zeros(F, bool)
    widths = []
    for gi, g in enumerate(final_groups):
        if len(g) == 1:
            j = g[0]
            bundle_of[j] = gi
            offset_of[j] = 0
            is_direct[j] = True
            widths.append(int(nbins[j]))
        else:
            off = 1
            for j in g:
                bundle_of[j] = gi
                offset_of[j] = off
                off += int(member_width[j])
            widths.append(off)
    B = max(widths)
    dtype = torch.uint8 if B <= 256 else torch.uint16
    out = bundle_columns(bins, final_groups, offset_of, dtype)

    # categorical members carry no NaN metadata: their NaN bin is just
    # another category
    nanb = np.array([int(nbins[j]) - 1
                     if (mappers[j].missing_type == MissingType.NAN
                         and not is_cat[j])
                     else -1 for j in range(F)], np.int64)
    member_at = np.full((G, B), -1, np.int32)
    tloc_at = np.zeros((G, B), np.int32)
    end_at = np.zeros((G, B), np.int32)
    nanpos_at = np.full((G, B), -1, np.int32)
    nan_at = np.zeros((G, B), bool)
    for gi, g in enumerate(final_groups):
        if len(g) == 1:
            j = g[0]
            nb = int(nbins[j])
            member_at[gi, :nb] = j
            tloc_at[gi, :nb] = np.arange(nb)
            end_at[gi, :nb] = gi * B + nb - 1
            if nanb[j] >= 0:
                nanpos_at[gi, :nb] = gi * B + int(nanb[j])
                nan_at[gi, int(nanb[j])] = True
        else:
            for j in g:
                off = int(offset_of[j])
                nb = int(nbins[j])
                # candidate positions off-1 .. off+nb-2 carry member
                # thresholds t = 0 .. nb-1 (off-1 is the t=0 cut; the
                # previous member's own slot there is its degenerate
                # all-left candidate, which validity always discards)
                lo, hi = off - 1, off + nb - 2
                member_at[gi, lo:hi + 1] = j
                tloc_at[gi, lo:hi + 1] = np.arange(nb)
                end_at[gi, lo:hi + 1] = gi * B + off + nb - 2
                # always overwrite nanpos over the member's range: off-1
                # is shared with the previous member's last slot
                if nanb[j] >= 0:
                    # the member's NaN bin maps to its last position
                    p_nan = off + int(nanb[j]) - 1
                    nanpos_at[gi, lo:hi + 1] = gi * B + p_nan
                    nan_at[gi, p_nan] = True
                else:
                    nanpos_at[gi, lo:hi + 1] = -1
    return BundleInfo(final_groups, bundle_of, offset_of, is_direct,
                      out, B, member_at, tloc_at, end_at,
                      nanpos_at, nan_at)


def bundle_columns(bins: torch.Tensor, groups: List[List[int]],
                   offset_of: np.ndarray, dtype) -> torch.Tensor:
    """The ``[n, G]`` bundled matrix of ``bins`` ``[n, F]``, on their
    device. Every feature gets a key per row — its bin for a singleton;
    for a member of a multi-member bundle, 0 at bin 0 and else its rank
    in the group (from 1) above its position ``off + bin - 1`` — and a
    bundle's column is the low 16 bits of its members' largest key: the
    position of the last member (in group order) that is nonzero, 0 when
    none is. One scatter-max per block of rows."""
    n, F = bins.shape
    dev = bins.device
    G = len(groups)
    bundle_of = np.zeros(F, np.int64)
    rank = np.zeros(F, np.int64)
    multi = np.zeros(F, bool)
    for gi, g in enumerate(groups):
        for r, j in enumerate(g):
            bundle_of[j] = gi
            rank[j] = r + 1
            multi[j] = len(g) > 1
    shift = torch.as_tensor(np.where(multi, rank << 16, 0).astype(np.int32),
                            device=dev)
    base = torch.as_tensor(np.where(multi, offset_of.astype(np.int64) - 1,
                                    0).astype(np.int32), device=dev)
    is_multi = torch.as_tensor(multi, device=dev)
    index = torch.as_tensor(bundle_of, device=dev)
    wide = bins.dtype == torch.uint16
    out = torch.empty((n, G), dtype=dtype, device=dev)
    step = max(1, _BLOCK_ELEMS // max(F, 1))
    for r0 in range(0, n, step):
        blk = bins[r0:r0 + step]
        b = blk.view(torch.int16).to(torch.int32) & 0xFFFF if wide \
            else blk.to(torch.int32)
        key = torch.where(is_multi & (b == 0), torch.zeros_like(b),
                          shift | (b + base))
        col = torch.zeros((b.shape[0], G), dtype=torch.int32, device=dev)
        col.scatter_reduce_(1, index.expand(b.shape[0], F), key, "amax")
        col &= 0xFFFF
        if dtype == torch.uint16:
            out[r0:r0 + step].view(torch.int16).copy_(col.to(torch.int16))
        else:
            out[r0:r0 + step] = col.to(dtype)
    return out


def bundle_columns_np(bins: np.ndarray, groups: List[List[int]],
                      offset_of: np.ndarray, dtype) -> np.ndarray:
    """The plain version of :func:`bundle_columns`: the JAX package's
    numpy loop over the host matrix ``[n, F]`` (later members win)."""
    binsT = np.ascontiguousarray(bins.T)
    outT = np.zeros((len(groups), bins.shape[0]), dtype)
    for gi, g in enumerate(groups):
        if len(g) == 1:
            outT[gi] = binsT[g[0]].astype(dtype)
        else:
            col = np.zeros(bins.shape[0], np.int64)
            for j in g:
                bj = binsT[j].astype(np.int64)
                sel = bj != 0
                col[sel] = offset_of[j] + bj[sel] - 1
            outT[gi] = col.astype(dtype)
    return outT.T
