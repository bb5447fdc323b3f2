"""Batched serving driver on PyTorch (the port of
``examples/serve_llm.py``): prefill + decode with an int8-encoded KV
cache.

The paper's E-D idea deployed for inference: the KV cache is *stored
encoded* (int8 + scales, ``kernels/kvq``) and decoded inside the
attention read (the hand-written split-K decode kernel on the card),
halving cache bytes against bf16.  Runs a small model end to end:

    python examples/serve_llm_torch.py [--arch llama3-8b] [--batch 4] \\
        [--gen 24] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU (the
kernels' plain PyTorch versions); with no card and no ``--device cpu`` it
exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.serve_step import (build_decode_step,  # noqa: E402
                                          build_prefill_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch)
    quant = not args.no_quantize
    model = transformer.init_params(cfg, 0, device=dev,
                                    dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    batch = {"tokens": prompts}
    if cfg.encoder is not None:          # zero frames, as the serve CLI's
        batch["frames"] = torch.zeros(
            (args.batch, cfg.encoder.n_frames, cfg.d_model), device=dev)

    # prefill grows the decode cache to prompt + gen before it returns
    prefill = build_prefill_step(cfg, policy_name="bf16", quantized=quant,
                                 s_max=args.prompt_len + args.gen)
    decode = build_decode_step(cfg, policy_name="bf16", quantized=quant)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        t0 = time.time()
        last_logits, cache = prefill(model, batch)
        tok = last_logits.argmax(-1).to(torch.int32)
        enc = transformer.run_encoder(model, cfg, batch["frames"]) \
            if cfg.encoder is not None else None
        sync()
        t_prefill = time.time() - t0

        out_tokens = [tok]
        t0 = time.time()
        for _ in range(args.gen - 1):
            logits, cache = decode(model, cache, tok, enc)
            tok = logits.argmax(-1).to(torch.int32)
            out_tokens.append(tok)
        sync()
        t_decode = time.time() - t0

    gen = torch.stack(out_tokens, 1).cpu().numpy()
    kv_bytes = sum(
        x.numel() * x.element_size() for k, x in cache.items()
        if k in ("k", "v", "k_scale", "v_scale", "mla_lat", "mla_rope"))
    print(f"arch={cfg.arch_id} quantized_cache={quant} device={dev}")
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill*1e3:.0f} ms")
    print(f"decode  {args.gen} tokens: {t_decode*1e3:.0f} ms "
          f"({t_decode/max(1, args.gen-1)*1e3:.1f} ms/tok)")
    print(f"cache bytes: {kv_bytes/2**20:.2f} MiB "
          f"({'int8+scales' if quant else 'bf16'})")
    print(f"generated (first row): {gen[0][:16].tolist()}")
    if not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise RuntimeError("generated a token outside the vocab")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
