"""Plain exact cosine top-k over a corpus fed a block at a time.

The reference of every cell: plain PyTorch, float32 with TF32 off, no
kernel, no padding, no plane of the program. It works out again from the
benchmark's own inputs (the float16 rows the benchmark made, the float32
queries it sent) everything the program derives: the unit-norm rows and
queries and every score.

For each query it keeps the k best true scores, and it looks up the true
score of each row id it is asked about (the program's answers), so the
judge can say how far below the true r-th best each answer lies. With
``control=True`` it also ranks in the nearest precision below the
configuration's float16, int8 with one scale per row and per query, the
step that would tempt a later change, and keeps the true scores of the
rows that ranking picks.
"""

from __future__ import annotations

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm in float32 (a zero row stays zero)."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation, one scale per row: (values as float64
    integers, (m, 1) float64 scales)."""
    x = x.double()
    scale = x.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x / scale), -127, 127), scale


class ExactScan:
    """Exact top-k of ``queries`` (S, d) float32 over rows fed in id order.

    ``probe`` is an optional (S, m) int64 array of row ids whose true scores
    are wanted (ids outside the corpus read NaN)."""

    def __init__(self, queries, k: int, probe=None, control: bool = False, device="cpu"):
        _no_tf32()
        self.device = torch.device(device)
        self.q = unit(torch.as_tensor(queries, device=self.device))
        s = self.q.shape[0]
        self.k = k
        self.top = torch.full((s, 0), float("-inf"), device=self.device)
        self.probe = None if probe is None else torch.as_tensor(probe, device=self.device).long()
        self.probed = None if probe is None else torch.full(self.probe.shape, float("nan"), device=self.device)
        self.control = control
        if control:
            self.q8, self.q_scale = int8_rows(self.q)
            self.c_score = torch.full((s, 0), float("-inf"), dtype=torch.float64, device=self.device)
            self.c_true = torch.full((s, 0), float("nan"), device=self.device)
            self.c_ids = torch.zeros((s, 0), dtype=torch.long, device=self.device)

    def feed(self, lo: int, rows: torch.Tensor) -> None:
        """Score rows ``lo .. lo + len(rows)`` (float16 or float32)."""
        r = unit(rows.to(self.device))
        scores = self.q @ r.T  # (S, m) float32
        m = r.shape[0]
        kk = min(self.k, m)
        self.top = torch.topk(torch.cat([self.top, torch.topk(scores, kk, dim=1).values], 1), min(self.k, self.top.shape[1] + kk), dim=1).values
        if self.probe is not None:
            hit = (self.probe >= lo) & (self.probe < lo + m)
            si, pi = hit.nonzero(as_tuple=True)
            self.probed[si, pi] = scores[si, self.probe[si, pi] - lo]
        if self.control:
            r8, r_scale = int8_rows(r)
            cs = (self.q8 @ r8.T) * self.q_scale * r_scale.T  # (S, m) float64
            cv, ci = torch.topk(cs, kk, dim=1)
            all_s = torch.cat([self.c_score, cv], 1)
            all_t = torch.cat([self.c_true, torch.gather(scores, 1, ci)], 1)
            all_i = torch.cat([self.c_ids, ci + lo], 1)
            keep = torch.topk(all_s, min(self.k, all_s.shape[1]), dim=1).indices
            self.c_score = torch.gather(all_s, 1, keep)
            self.c_true = torch.gather(all_t, 1, keep)
            self.c_ids = torch.gather(all_i, 1, keep)

    def result(self) -> dict:
        """Host arrays: ``top`` (S, k) true best scores, descending;
        ``probed`` the true scores of the probe ids; with the control,
        ``control_ids`` / ``control_scores`` (its ranking, best first, and
        its own scores) and ``control_true`` (their true scores)."""
        out = {"top": self.top.cpu().numpy()}
        if self.probe is not None:
            out["probed"] = self.probed.cpu().numpy()
        if self.control:
            order = torch.argsort(-self.c_score, dim=1, stable=True)
            out["control_ids"] = torch.gather(self.c_ids, 1, order).cpu().numpy()
            out["control_scores"] = torch.gather(self.c_score, 1, order).float().cpu().numpy()
            out["control_true"] = torch.gather(self.c_true, 1, order).cpu().numpy()
        return out


def scan_corpus(corpus, queries, k: int, probe=None, control: bool = False) -> dict:
    """Run :class:`ExactScan` over every block of a :class:`perfbench.data.Corpus`,
    regenerating each block from the seed on the corpus' device."""
    scan = ExactScan(queries, k, probe=probe, control=control, device=corpus.device)
    for i, lo, _hi in corpus.blocks():
        scan.feed(lo, corpus.rows(i))
    if corpus.device.type == "cuda":
        torch.cuda.synchronize(corpus.device)
    return scan.result()
