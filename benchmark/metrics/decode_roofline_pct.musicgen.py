"""decode_roofline_pct.musicgen: kernel D's share of its roofline. Over D's
launches in the traced window (`decode_step_kernel`, one a step), the sum
of each one's least time (counts/musicgen.decode_launch at the request's
CFG rows, its offset and the prompt's T5 length: the layers' weights, the
live K and V rows and the text's K and V read once) over their device time,
in percent. Nothing is read unless the trace holds one launch a step."""

from pathlib import Path

from benchmark.counts.musicgen import request_steps
from benchmark.counts.peaks import bound_s
from benchmark.reference.tokenizers import UnigramT5

KERNEL = "decode_step_kernel"


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    tok = UnigramT5(Path(__file__).resolve().parents[1] / "assets" / "spiece" / "t5_like.model")
    least, launches = 0.0, 0
    for r in ctx.records:
        if r.error:
            continue
        q = r.req
        steps = max(8, min(int(q["max_steps"]), 2500))
        text = len(tok.encode(q["prompt"], pad=False))
        launches += steps
        least += sum(bound_s(f, b) for f, b in
                     request_steps(ctx.config["decoder"], 2 * q["n_samples"], steps, text, launch=True))

    def is_d(o):
        return KERNEL in o.name

    if not launches or tl.count(is_d) != launches:
        return None
    return 100.0 * least / tl.device_time(is_d)
