"""mfu_pct.flux: the products that the images completed in the traced
run's completion interval need (T5 over its padded tokens, CLIP over the
prompt's, every flow step, the VAE decode; counts/flux.image_flops) over
that interval at the card's bf16 peak, in percent."""

from pathlib import Path

from benchmark.counts.flux import image_flops
from benchmark.counts.peaks import PEAK_BF16_FLOPS
from benchmark.harness import rate
from benchmark.reference.tokenizers import BpeCLIP


def read(ctx):
    _, first, last = rate(ctx.records, ctx.close)
    if ctx.timeline is None or first is None:
        return None
    clip = BpeCLIP(Path(__file__).resolve().parents[1] / "assets" / "clip_tokenizer")
    flops = 0.0
    for r in ctx.records:
        if first < r.done <= last and not r.error:
            q = r.req
            flops += r.units * image_flops(ctx.config, q["width"], q["height"], q["steps"] or 2,
                                           len(clip.encode(q["prompt"])))
    return 100.0 * flops / ((last - first) * PEAK_BF16_FLOPS)
