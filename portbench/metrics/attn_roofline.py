"""attn_roofline: the attention kernel's share of its roofline, in %: over
the traced window's fits, each fit's least time of its attention
(``portbench.lmwork.attn_least_ms_per_fit``: the visible pairs' forward
and backward operations at the fp32 peak) over the device time of the
kernels named ``attn_fwd_kernel``, ``attn_bwd_dkdv_kernel`` and
``attn_bwd_dq_kernel``.  A fit that launched another count of them is left
out; unread where no fit is left (a program without the kernel)."""

import re

from portbench import lmwork, tracing

NAMES = re.compile(r"\battn_(fwd|bwd_dkdv|bwd_dq)_kernel\b")


def read(ctx):
    if ctx.trace is None:
        return None
    want = lmwork.attn_launches_per_fit(ctx.cfg)
    fits, dev_s = 0, 0.0
    for ops in tracing.ops_by_fit(ctx.trace):
        mine = [o for o in ops if o.kernel and NAMES.search(o.name)]
        if len(mine) == want:
            fits += 1
            dev_s += sum(o.end - o.start for o in mine)
    if not fits or dev_s <= 0:
        return None
    return 100.0 * fits * lmwork.attn_least_ms_per_fit(ctx.cfg) \
        / (dev_s * 1e3)
