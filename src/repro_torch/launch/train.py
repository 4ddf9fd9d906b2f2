"""The training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --device cpu --steps 200 --ckpt-dir /tmp/ckpt

The JAX CLI's flags, defaults and printed lines, plus ``--device`` (the GPU
by default; it raises when there is none). Real training on one device:
the synthetic deterministic data pipeline, AdamW, checkpoints through the
async writer, crash-resume, and with ``--pods N`` the paper's hierarchical
two-tier synchronisation (local steps every step, cross-pod averaging every
D-th, optionally int8-compressed), the pods emulated by the leading replica
axis.

Checkpoints hold ``{"params", "opt"}`` in the JAX package's tree and format
(each model's own stacks), so either CLI resumes the other's, for every
architecture. The stub frontends' inputs (whisper's ``frames``, internvl's
``patch_embeds``) are zeros of their specs, as in the JAX CLI. The initial
weights are drawn from a ``torch.Generator`` seeded 0 (the JAX CLI draws
from ``PRNGKey(0)``, so the two start from different weights unless one
resumes the other's checkpoint). The slow tier's sync state is not
checkpointed by either CLI: as in the JAX CLI, its anchor is the fresh
init's weights, taken before any restore, and its error residuals start at
zero. A resume before the first sync therefore repeats the uninterrupted
run; with ``--compression int8`` a resumed run's syncs read the resuming
CLI's own init, so a crossed int8 resume repeats the other CLI's run only
where both drew the same weights.

The step runs under ``torch.use_deterministic_algorithms`` (with cuBLAS's
fixed workspace), so a resumed run repeats the uninterrupted run bitwise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.hierarchical import HierarchicalConfig
from repro_torch.optim.tree import named_leaves
from repro_torch.train.steps import make_train_artifacts

__all__ = ["main", "train_state_tree", "load_train_state"]


def train_state_tree(model, params, opt_state, lead: int = 0, device=None) -> dict:
    """``{"params", "opt": {"count", "m", "v"}}`` in ``model``'s JAX layout
    (``lead`` leading pod axes before the layer axis), each tensor copied to
    ``device`` (None: the live tensors, where they are). The step updates the
    live ones in place, so the checkpoint writer gets copies even on the
    CPU."""
    def copy(x):
        return x.detach() if device is None else x.detach().to(device, copy=True)

    def move(named):
        return model.to_jax_layout({n: copy(x) for n, x in named.items()}, lead)

    return {"params": move(named_leaves(params)),
            "opt": {"count": copy(opt_state["count"]),
                    "m": move(opt_state["m"]), "v": move(opt_state["v"])}}


@torch.no_grad()
def load_train_state(directory: str, model, params, opt_state, lead: int = 0) -> int:
    """Restore the latest checkpoint of :func:`train_state_tree`'s layout
    into the live ``params`` and ``opt_state`` (in place, through the
    host). Returns its step."""
    like = train_state_tree(model, params, opt_state, lead, device="meta")
    restored, step = ckpt.restore(directory, like, device="cpu")
    live = {"params": named_leaves(params), "m": opt_state["m"], "v": opt_state["v"]}
    for part, tree in (("params", restored["params"]), ("m", restored["opt"]["m"]),
                       ("v", restored["opt"]["v"])):
        for name, x in model.from_jax_layout(tree, lead).items():
            live[part][name].copy_(x)
    opt_state["count"].copy_(restored["opt"]["count"])
    return step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--pods", type=int, default=0,
                    help=">0: hierarchical trainer with this many pod replicas")
    ap.add_argument("--sync-every", type=int, default=10,
                    help="D: cross-pod sync period (paper eq. 1)")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # cuBLAS is deterministic only with a fixed workspace, set before its
        # first handle.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train(args, device)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _train(args, device: torch.device) -> None:
    bundle = get_arch(args.arch, reduced=args.reduced)
    vocab = bundle.cfg.vocab
    n_params_cfg = bundle.cfg.param_count()
    print(f"arch={args.arch} reduced={args.reduced} "
          f"params(cfg)={n_params_cfg/1e6:.1f}M device={device}")

    hier_cfg = None
    if args.pods > 0:
        hier_cfg = HierarchicalConfig(sync_every=args.sync_every,
                                      compression=args.compression)

    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=bundle.moment_dtype,
                          warmup_steps=max(args.steps // 10, 1))
    art = make_train_artifacts(bundle, opt_cfg, hier_cfg=hier_cfg, n_pods=max(args.pods, 1),
                               n_micro=args.n_micro)

    params = bundle.model.init_params(torch.Generator(device).manual_seed(0))
    params.requires_grad_()
    opt_state = adamw_init(params, opt_cfg)
    lead, sync_state = 0, None
    if hier_cfg is not None:
        hier, lead = art.hier, 1
        sync_state = hier.init_sync_state(params)
        params = hier.replicate(params)
        opt_state = hier.replicate(opt_state)

    start_step = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncWriter(args.ckpt_dir, keep=3)
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            start_step = load_train_state(args.ckpt_dir, bundle.model, params, opt_state, lead)
            print(f"resumed from step {start_step}")

    ds = SyntheticLM(vocab=vocab, seq_len=args.seq_len, global_batch=args.global_batch)

    n_pods = args.pods if hier_cfg is not None else None

    def make_batch(step):
        batch = host_batch(ds.batch(step), device, n_pods=n_pods)
        # The stub frontends' inputs (whisper's frames, internvl's patches)
        # as zeros of their specs, as the JAX CLI feeds them.
        for name, make in bundle.extra_inputs.items():
            spec = make(args.global_batch, args.seq_len)
            x = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
            batch[name] = x if n_pods is None else x.reshape((n_pods, -1) + x.shape[1:])
        return batch

    def host_state():
        return train_state_tree(bundle.model, params, opt_state, lead, device="cpu")

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = make_batch(step)
        params, opt_state, metrics = art.step_fn(params, opt_state, batch)
        if hier_cfg is not None and (step + 1) % hier_cfg.sync_every == 0:
            params, sync_state = art.sync_fn(params, sync_state)
        loss = float(metrics["loss"].float().mean())
        losses.append(loss)
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (step + 1 - start_step)
            print(f"step {step+1:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm'].float().mean()):8.3f} "
                  f"{dt*1e3:7.1f} ms/step")
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.submit(step + 1, host_state())

    if writer:
        # The JAX CLI writes the last step again here even when the loop
        # just did; the port writes it once (the same files either way).
        if args.steps % args.ckpt_every or args.steps == start_step:
            writer.submit(args.steps, host_state())
        writer.close()
    first = np.mean(losses[: max(len(losses) // 10, 1)])
    last = np.mean(losses[-max(len(losses) // 10, 1):])
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'}) "
          f"over {args.steps - start_step} steps")


if __name__ == "__main__":
    main()
