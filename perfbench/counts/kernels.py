"""Operations and bytes of one call of each kernel on the port's path,
from the call's shapes alone: the work the operation needs, so the same
call counts the same whoever implements it.  Each input byte is counted
read once and each output byte written once; bf16 operands are 2 bytes.

The arithmetic is the port's kernel table's (chip_smoke's rows): the GRU
counts T - 1 step products (h_{-1} = 0), its backward the dW product over
all T positions.  Where the work depends on the data, a function takes
what the inputs need: the rows of the feature table a batch reads.

``bound_s(work)``: the least time one H100 could take, the larger of the
operations over the peak rate and the bytes over the HBM rate.
"""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def bound_s(work: tuple, rate: str = "bf16_flops") -> float:
    flops, nbytes = work
    pk = peaks()
    return max(flops / pk[rate], nbytes / pk["hbm_bytes"])


def gru_fwd(seq_len: int, batch: int, dim_h: int, mask_gates: int = 3,
            want_hproj: bool = True) -> tuple:
    """3f / 3f': the recurrence over T steps (T - 1 step products); xp, W,
    b and the masks read, the states (and h_proj) written."""
    t, b, h = seq_len, batch, dim_h
    flops = 2 * (t - 1) * b * h * 3 * h
    nbytes = ((t * b * 3 * h + 3 * h * h + mask_gates * b * h + t * b * h
               + (t * b * 3 * h if want_hproj else 0)) * 2 + 3 * h * 4)
    return flops, nbytes


def gru_bwd(seq_len: int, batch: int, dim_h: int, mask_gates: int = 3
            ) -> tuple:
    """3b as the kernel table counts it: the reverse sweep's T - 1 back
    products and the dW product over T positions; xp, h_proj, the states,
    their cotangents, the masks and W read, dxp, dW, db written."""
    t, b, h = seq_len, batch, dim_h
    flops = 2 * (t - 1) * b * 3 * h * h + 2 * t * b * 3 * h * h
    nbytes = (t * b * 3 * h * 2 * 3 + t * b * h * 2 * 2 + mask_gates * b * h
              * 2 + 3 * h * h * 2 * 2 + 3 * h * 4)
    return flops, nbytes


def gru_bwd_sweep(steps_sum: int, rows_sum: int, batch: int, dim_h: int,
                  mask_gates: int = 3) -> tuple:
    """The reverse sweep's own launches (``gru_bwd_step_kernel``), without
    the library's dW product: ``steps_sum`` back products (B x (T - 1)
    over a padded batch) and the bytes of the ``rows_sum`` positions
    (B x T) it reads and writes: xp, h_proj, the states and their
    cotangents read, dxp and dh_proj written, W and the masks read
    once."""
    h = dim_h
    flops = 2 * steps_sum * 3 * h * h
    nbytes = (rows_sum * (3 * h * 2 * 2 + h * 2 * 2 + 3 * h * 2 * 2)
              + mask_gates * batch * h * 2 + 3 * h * h * 2)
    return flops, nbytes


def vfeat_fwd(batch: int, k: int, dim_v: int, hid: int, rows: int) -> tuple:
    """1f: v_other and v_mult through their two blocks of linear_1 for
    every candidate, and v_dist; ``rows`` table rows read."""
    flops = 4 * batch * k * dim_v * hid
    nbytes = (rows * dim_v * 2 + batch * (k + 1) * 4 + 2 * hid * dim_v * 2
              + batch * k * hid * 2 + batch * k * 4)
    return flops, nbytes


def vfeat_bwd(batch: int, k: int, dim_v: int, hid: int, rows: int) -> tuple:
    """1b: the two blocks' weight gradients (f32 out)."""
    flops = 4 * batch * k * dim_v * hid
    nbytes = (rows * dim_v * 2 + batch * (k + 1) * 4 + batch * k * hid * 2
              + 2 * hid * dim_v * 4)
    return flops, nbytes


def mixture(m: int, dim_z: int, n_ans: int) -> tuple:
    """2: the answer head and its softmax over M candidate rows."""
    return (2 * m * dim_z * n_ans,
            (m * dim_z + n_ans * dim_z + n_ans + m * n_ans) * 2)


def mutan(batch: int, dim_hv: int, dim_hq: int, rank: int, dmm: int
          ) -> tuple:
    """#4: both sides' rank projections and their Hadamard sum."""
    return (2 * batch * rank * dmm * (dim_hv + dim_hq),
            batch * (dim_hv + dim_hq) * 2 + rank * dmm * (dim_hv + dim_hq) * 2
            + 2 * rank * dmm * 4 + batch * dmm * 4)
