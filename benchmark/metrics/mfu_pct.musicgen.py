"""mfu_pct.musicgen: the whole AR step's share of the card's peak. For each
step of the requests completed in the traced run's completion interval, the
least time of the step (counts/musicgen.step: the fused decoder step and
the output heads, each weight read once, the live cache rows and the text's
K and V) at the bf16 peak and the memory rate, summed over the interval's
length, in percent. The text length is the prompt's own T5 token count."""

from pathlib import Path

from benchmark.counts.musicgen import request_steps
from benchmark.counts.peaks import bound_s
from benchmark.harness import rate
from benchmark.reference.tokenizers import UnigramT5


def read(ctx):
    _, first, last = rate(ctx.records, ctx.close)
    if ctx.timeline is None or first is None:
        return None
    tok = UnigramT5(Path(__file__).resolve().parents[1] / "assets" / "spiece" / "t5_like.model")
    least = 0.0
    for r in ctx.records:
        if first < r.done <= last and not r.error:
            q = r.req
            steps = max(8, min(int(q["max_steps"]), 2500))
            text = len(tok.encode(q["prompt"], pad=False))
            least += sum(bound_s(f, b) for f, b in
                         request_steps(ctx.config["decoder"], 2 * q["n_samples"], steps, text))
    return 100.0 * least / (last - first)
