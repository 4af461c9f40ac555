"""The training step's share of the card's bf16 peak: model FLOPs of the
window's tokens (6 N + 12 L d T a token, ``counts.model_flops_per_token``)
over 989e12 times the window's seconds, in %."""
import peaks


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    flops = w["tokens"] * ctx["counts"]["flops_per_token"]
    return 100.0 * flops / (peaks.BF16_FLOPS * w["seconds"] * ctx["world"])
