"""Serve a small LM with batched requests on the PyTorch port: prefill + a
greedy decode loop over a KV cache.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3-4b --tokens 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The same flags as ``examples/serve_lm.py`` (the JAX package's script) plus
``--device`` (default ``cuda``; without a GPU pass ``--device cpu``). Like
that script it runs the reduced configuration of ``--arch``, any
decoder-only one (dense, MoE such as ``qwen2-moe-a2.7b``, recurrent such as
``recurrentgemma-2b`` or ``xlstm-350m``), with weights drawn from a
generator seeded 0; the encoder-decoder (whisper) is driven through
``Model.prefill(frames, tokens, max_seq)`` instead.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma3-4b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--tokens", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    cfg = get_reduced(args.arch)
    if cfg.arch_type == "encdec":
        raise SystemExit("this script is decoder-only; serve whisper through "
                         "Model.prefill(frames, tokens, max_seq)")
    device = torch.device(args.device)
    model = build_model(cfg, device=device)  # weights from a generator seeded 0
    max_seq = args.prompt_len + args.tokens

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len))
    prompts = torch.from_numpy(prompts).to(device)

    print(f"prefill: batch={args.batch} prompt_len={args.prompt_len}")
    t0 = time.perf_counter()
    kw = {}
    if cfg.prefix_len:
        kw["prefix_embeds"] = torch.zeros(
            (args.batch, cfg.prefix_len, cfg.d_model), dtype=torch.float32, device=device)
    last_logits, caches = model.prefill(prompts, max_seq, **kw)
    _sync(device)
    print(f"  prefill {time.perf_counter()-t0:.2f}s")

    tok = torch.argmax(last_logits[:, -1], dim=-1)[:, None]
    out_tokens = [tok[:, 0]]
    pos = torch.full((args.batch,), args.prompt_len + cfg.prefix_len - 1, device=device)

    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        pos = pos + 1
        logits, caches = model.decode_step(caches, tok, pos)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out_tokens.append(tok[:, 0])
    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens/request in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s total)")
    print("generated ids (req 0):", gen[0].tolist())


if __name__ == "__main__":
    main()
