"""Serving driver: batched greedy decode with KV caches.

Runs a reduced assigned arch end to end (prefill + N decode steps), as
``repro/launch/serve.py`` does, on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
      --batch 4 --prompt-len 32 --gen-len 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b          # MLA latent cache, routed experts

Params, prompts and the vlm patch embeddings are drawn from ``--seed``
(in distribution only: ``jax.random`` cannot be replayed in torch).
``generate`` is the loop itself, for callers with their own params.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import frontends
from repro_torch.models.model import (decode_step, forward, init_params,
                                      make_caches)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg, prompts, gen_len, *, prefix_embeds=None):
    """Prefill ``prompts`` (B, S) into fresh caches, then ``gen_len - 1``
    greedy decode steps. Returns a dict: ``tokens`` (B, gen_len) — the
    prefill's argmax, then each step's —, ``prefill_logits`` (B, V) at
    the last prompt position, ``step_logits`` (one (B, V) a step),
    ``prefill_s`` and ``decode_s`` (synchronised wall time)."""
    device = prompts.device
    B, S = prompts.shape
    prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    caches = make_caches(cfg, B, prefix + S + gen_len, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = forward(params, prompts, cfg, caches=caches,
                                prefix_embeds=prefix_embeds)
    last = logits[:, -1]
    next_tok = torch.argmax(last[:, :cfg.vocab_size], dim=-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out, step_logits = [next_tok], []
    offset = prefix + S
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, caches = decode_step(params, caches, next_tok, offset + i,
                                     cfg)
        next_tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        out.append(next_tok)
        step_logits.append(logits)
    _sync(device)
    return {"tokens": torch.stack(out, dim=1), "prefill_logits": last,
            "step_logits": step_logits, "prefill_s": t_prefill,
            "decode_s": time.perf_counter() - t0}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def serve(args):
    """The reduced arch's params, prompts and (vlm) patches from
    ``args.seed``, then ``generate``. Returns ``(cfg, params, inputs,
    result)``, ``inputs`` the ``forward`` keywords of the prompt."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_params(args.seed, cfg, device=device)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).to(device)
    prefix = None
    if cfg.family == "vlm":
        prefix = frontends.vision_patch_embeddings(gen, args.batch,
                                                   cfg).to(device)
    res = generate(params, cfg, prompts, args.gen_len, prefix_embeds=prefix)
    return cfg, params, {"tokens": prompts, "prefix_embeds": prefix}, res


def main(argv=None):
    """Serves the reduced arch, prints the timings and the first row's
    tokens, and returns ``serve``'s tuple."""
    args = make_parser().parse_args(argv)
    out = serve(args)
    res = out[3]
    G = args.gen_len
    print(f"arch={args.arch} (reduced) batch={args.batch} "
          f"prompt={args.prompt_len} gen={G}")
    print(f"prefill {res['prefill_s'] * 1e3:.1f} ms; decode "
          f"{res['decode_s'] / max(G - 1, 1) * 1e3:.1f} ms/token")
    print("generated token ids (first row):", res["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main()
