"""The comparisons that decide ``correct``: the program's answers against
the reference's, exactly (every limit is 0)."""
from __future__ import annotations

import numpy as np
import torch


def scan_answer(keep: torch.Tensor, outs: dict, types: dict,
                dictionaries: dict) -> dict:
    """A scan's answer from a reference's row mask and dense outputs:
    the survivors' indices, and each output's values on them (a decimal's
    high limb is its sign, as its values fit in 64 bits)."""
    idx = torch.nonzero(keep).flatten()
    cols = {}
    for name, t in types.items():
        data = outs[name][idx].to(torch.int64)
        cols[name] = {"data": data,
                      "hi": (data >> 63) if t.startswith("decimal") else None,
                      "valid": torch.ones_like(idx, dtype=torch.bool),
                      "dictionary": dictionaries.get(name)
                      if t == "string" else None}
    return {"indices": idx, "columns": cols}


def compare_scan(got: dict, want: dict) -> dict:
    """{"differing_selection": rows selected by one side only,
    "differing_values": output values (value, high limb, validity, or a
    string's text) that differ on rows both select}."""
    gi, wi = got["indices"], want["indices"]
    if gi.numel() == wi.numel() and torch.equal(gi, wi):
        diff_sel, gpos, wpos = 0, slice(None), slice(None)
    else:
        in_w, in_g = torch.isin(gi, wi), torch.isin(wi, gi)
        diff_sel = int((~in_w).sum()) + int((~in_g).sum())
        gpos, wpos = in_w.nonzero().flatten(), in_g.nonzero().flatten()
    common = int(want["indices"][wpos].numel())
    diff_val = 0
    for name, w in want["columns"].items():
        g = got["columns"].get(name)
        if g is None:
            diff_val += common
            continue
        gd, wd = g["data"][gpos].to(torch.int64), w["data"][wpos]
        if w["dictionary"] is not None:
            # compare texts: each of the program's codes as the position of
            # its string in the reference's dictionary (-1 if absent)
            where = {v: i for i, v in enumerate(w["dictionary"])}
            texts = g["dictionary"] or []
            remap = torch.tensor([where.get(v, -1) for v in texts] or [-1],
                                 device=gd.device)
            inside = (gd >= 0) & (gd < len(texts))
            gd = torch.where(inside, remap[gd.clamp(0, remap.numel() - 1)],
                             -1)
        bad = gd != wd
        if w["hi"] is not None:
            hi = g["hi"]
            bad |= (hi[gpos].to(torch.int64) != w["hi"][wpos]
                    if hi is not None else torch.ones_like(bad))
        bad |= g["valid"][gpos] != w["valid"][wpos]
        diff_val += int(bad.sum())
    return {"differing_selection": diff_sel, "differing_values": diff_val}


def compare_groups(got: tuple, want: tuple) -> dict:
    """A grouped answer (keys, sums, counts, joined rows) against the
    reference's: {"differing_answers": 0 or 1, "sum_error": the largest
    difference of a sum, in cents}."""
    gk, gs, gc, gj = got
    wk, ws, wc, wj = want
    same_keys = np.array_equal(np.asarray(gk), wk)
    same = (same_keys and np.array_equal(np.asarray(gs), ws)
            and np.array_equal(np.asarray(gc), wc) and int(gj) == wj)
    err = (int(np.abs(np.asarray(gs, dtype=np.int64) - ws).max(initial=0))
           if same_keys else int(np.abs(ws).max(initial=0)))
    return {"differing_answers": 0 if same else 1, "sum_error": err}
