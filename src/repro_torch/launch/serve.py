"""Batched serving entry point of the port: prefill a batch of prompts,
then decode greedily with the KV cache (``lm``, ``moe``), the KV and
recurrent caches (``rglru``) or the WKV state (``rwkv6``).  Parameters come
from ``models.api.build(cfg).init``.  As the reference's serve, it
supports the decoder-only families and refuses ``encdec`` and ``vlm``.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises rather than carry on on the CPU.
A prefill's attention runs through the flash attention kernel, every
RG-LRU scan through the RG-LRU kernel and every WKV recurrence through
the WKV6 kernel; decode steps are plain PyTorch.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 8 \\
        --prompt-len 4096 --gen 32
    python -m repro_torch.launch.serve --arch rwkv6-7b --batch 8 \\
        --prompt-len 4096 --gen 32
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --batch 8 \\
        --prompt-len 4096 --gen 16
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --batch 2 --prompt-len 40 --gen 8 --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import api
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as W
from repro_torch.models import transformer as T


@dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen) greedy tokens
    prefill_seconds: float
    decode_tokens_per_s: float    # (gen - 1) * B tokens over the decode loop
    last_logits: torch.Tensor     # (B, vocab_padded) of the last step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


DECODER_ONLY = ("lm", "moe", "rglru", "rwkv6")


def model_fns(cfg):
    """``(prefill(params, prompts, max_len), decode_step)`` of the config's
    decoder-only family."""
    if cfg.family in ("lm", "moe"):
        return (lambda p, tok, n: T.prefill(cfg, p, tok, n),
                lambda p, c, tok, n: T.decode_step(cfg, p, c, tok, n))
    if cfg.family == "rglru":
        return (lambda p, tok, n: G.prefill(cfg, p, tok),
                lambda p, c, tok, n: G.decode_step(cfg, p, c, tok, n))
    if cfg.family == "rwkv6":       # the state does not grow: no lengths
        return (lambda p, tok, n: W.prefill(cfg, p, tok),
                lambda p, c, tok, n: W.decode_step(cfg, p, c, tok))
    raise ValueError(f"serve supports decoder-only archs, not {cfg.family}")


@torch.inference_mode()
def main(argv=None) -> ServeResult:
    """Serve one batch of random prompts with random weights (both from
    ``--seed``)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family not in DECODER_ONLY:
        raise SystemExit(f"serve demo supports decoder-only archs, not "
                         f"{cfg.family}")
    prefill, decode = model_fns(cfg)
    params = api.build(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed), device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    max_len = args.prompt_len + args.gen

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts, max_len)
    tok = logits[..., :cfg.vocab].argmax(-1)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{prefill_s:.3f}s", flush=True)

    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, caches = decode(params, caches, tok, args.prompt_len + i)
        tok = logits[..., :cfg.vocab].argmax(-1)[:, None]
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(device)
    dt = time.perf_counter() - t0
    rate = (args.gen - 1) * args.batch / dt if args.gen > 1 else 0.0
    print(f"[serve] decoded {args.gen - 1} steps x {args.batch} seqs in "
          f"{dt:.3f}s ({rate:.1f} tok/s)", flush=True)
    return ServeResult(tokens, prefill_s, rate, logits)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    res = main()
    for row in res.tokens.tolist():
        print("  ", row)
