"""Batched LM serving: prefill a prompt batch, then decode tokens.

The port of ``examples/serve_lm.py``. Prefill fills the KV cache for a batch
of random prompts, then a decode loop emits one greedy token per step.
Reports prefill and decode throughput (host clock around work that ends in a
device synchronisation). By default the model runs at its published width
and dtypes on the GPU, weights drawn from ``--seed``; ``--reduced`` takes
the smoke-scale config, which runs on the CPU in seconds. ``--arch`` takes
any of the ten registered architectures; whisper's frame embeddings and
internvl's patch embeddings (their stubbed frontends' outputs) are drawn
from ``--seed`` on the device:

    PYTHONPATH=src python -m repro_torch.serve_lm                       # GPU, full width
    PYTHONPATH=src python -m repro_torch.serve_lm --reduced --device cpu --arch whisper-medium

zamba2's shared attention block attends over its whole cache in place, so
from ``FLASH_THRESHOLD`` prompt tokens on, ``--prompt-len`` + ``--tokens``
must be a multiple of 1024 (the streaming path's key block), as in the JAX
package.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.train.steps import make_serve_artifacts

__all__ = ["serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(bundle, params, *, batch: int, prompt_len: int, tokens: int, seed: int = 0) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (with the
    bundle's extra inputs drawn from ``seed``, standard normal) and decode
    ``tokens`` greedy tokens (the first comes from the prefill), with a KV
    cache in the compute dtype. Returns the generated tokens
    ``[batch, tokens]``, the last logits and the timings."""
    cfg = bundle.cfg
    device = next(params.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                      device=device)}
    for name, make in bundle.extra_inputs.items():
        spec = make(batch, prompt_len)
        prompt[name] = torch.randn(spec.shape, generator=gen, device=device).to(spec.dtype)
    shape = ShapeSpec("serve", "prefill", prompt_len + tokens, batch)
    art = make_serve_artifacts(bundle, shape, cache_dtype=cfg.cdtype)

    _sync(device)
    t0 = time.perf_counter()
    logits, state = art.prefill_fn(params, prompt)
    tok = torch.argmax(logits, dim=-1)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(tokens - 1):
        logits, state = art.decode_fn(params, state, tok, prompt_len + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return dict(tokens=torch.cat(out, dim=1), logits=logits, prefill_s=prefill_s,
                decode_s=decode_s, decode_steps=tokens - 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 4096, or 32 with --reduced")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    prompt_len = args.prompt_len or (32 if args.reduced else 4096)

    bundle = get_arch(args.arch, reduced=args.reduced)
    params = bundle.model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    r = serve(bundle, params, batch=args.batch, prompt_len=prompt_len,
              tokens=args.tokens, seed=args.seed)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{bundle.cfg.name} on {where}")
    print(f"prefill: batch {args.batch} x {prompt_len} tokens in {r['prefill_s'] * 1e3:.1f} ms "
          f"({args.batch * prompt_len / r['prefill_s']:,.0f} tok/s)")
    steps = r["decode_steps"]
    if steps:
        print(f"decode:  {steps} steps x batch {args.batch} in {r['decode_s'] * 1e3:.1f} ms "
              f"({args.batch * steps / r['decode_s']:,.0f} tok/s, "
              f"{r['decode_s'] / steps * 1e3:.2f} ms/step)")
    print(f"generated shape: {tuple(r['tokens'].shape)}; first row: "
          f"{r['tokens'][0, :12].tolist()} ...")
    return r


if __name__ == "__main__":
    main()
