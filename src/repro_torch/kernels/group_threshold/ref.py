"""Plain PyTorch version of the row-wise group hard threshold (paper
eq. 5-6), the master step of DSML.

B: (p, m) stacked debiased estimates (variables x tasks). Returns the
filtered matrix and the support indicator,

    keep_j = sum_t B[j, t]^2 > Lambda^2 ;   out_j = keep_j ? B_j : 0

with the squares summed in float32 and Lambda^2 rounded to float32: the
comparison of the reference's Pallas body (`_gt_kernel`), which the CUDA
kernel makes too, so that the two agree on the card. The reference's own
oracle compares sqrt(sum) > Lambda instead (see `ops.group_threshold`).
"""
from __future__ import annotations

import numpy as np
import torch


def group_threshold_ref(B: torch.Tensor, Lam
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """B (p, m) float32 or bfloat16, Lam a number -> (filtered (p, m) in
    B's dtype, keep (p,) bool)."""
    b = B.to(torch.float32)
    lam = np.float32(Lam)
    keep = torch.sum(b * b, dim=1) > float(lam * lam)
    return torch.where(keep[:, None], B, torch.zeros((), dtype=B.dtype,
                                                     device=B.device)), keep
