"""The forward Myers kernel's share of its roofline over the traced
window (ops/kernels.myers_distances, csrc/myers.cu ``myers_kernel``).

Time: the kernel's device time in the window, from torch.profiler.

Work, counted from the benchmark's own inputs and not from the
program's launches: each typo the window sent is new to the engine,
and the Levenshtein <= 2 sweep must hold it against every vocabulary
word whose length lies within 2 of its own.  A (typo, word) pair costs
one Myers step per letter of the word, and a step on a pattern of up
to 64 letters (one word) costs OPS_PER_STEP word operations.

Peak: an SM issues at most four warp-instructions, 128 lane operations,
a clock; 132 SMs at 1980 MHz (the H100 SXM's boost clock) give 3.345e13
operations a second.  Each word operation is at least one instruction,
so the share cannot pass 100 %.  The bytes (each band's letters read
once a typo) bound it lower than the operations at these shapes.
"""

import re

import numpy as np

# Hyyro's formulation of Myers' step: Xv = Eq | Mv (1); Xh = (((Eq & Pv)
# + Pv) ^ Pv) | Eq (4); Ph = Mv | ~(Xh | Pv) (3); Mh = Pv & Xh (1); the
# shifts Ph << 1 | 1 and Mh << 1 (3); Pv = Mh | ~(Xv | Ph) (3);
# Mv = Ph & Xv (1).  The score's update is not counted.
OPS_PER_STEP = 16
LANES_PER_SM_CLOCK = 128
CLOCK_HZ = 1.98e9
TOL = 2


def is_forward(name: str) -> bool:
    return re.search(r"(?<!\w)myers_kernel(?!\w)", name) is not None


def read(run):
    if run.dtrace is None or not run.typos or not run.sm_count:
        return None
    t = sum(min(e, run.t1) - max(s, run.t0) for n, s, e in run.dtrace.ops
            if is_forward(n) and e > run.t0 and s < run.t1)
    if t <= 0:
        return None
    lens = np.asarray(run.word_lengths)
    n_of = np.bincount(lens, minlength=70)
    letters_of = n_of * np.arange(len(n_of))
    steps = 0
    for typo in run.typos:
        q = len(typo.encode())
        lo, hi = max(1, q - TOL), q + TOL
        steps += int(letters_of[lo: hi + 1].sum()) * -(-q // 64)
    ops = steps * OPS_PER_STEP
    peak = run.sm_count * LANES_PER_SM_CLOCK * CLOCK_HZ
    return 100.0 * (ops / peak) / t
