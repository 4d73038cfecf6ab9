"""Train a language model end to end on the PyTorch port with the production
loop: sharded init, AdamW, microbatching, checkpoint/restart, straggler
monitoring.

    PYTHONPATH=src python examples/train_lm_torch.py
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30
    PYTHONPATH=src python examples/train_lm_torch.py --arch olmo-1b --full --steps 8
    PYTHONPATH=src python examples/train_lm_torch.py --resume --ckpt-dir build/lm_ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/train_lm_torch.py \
        --device cpu --arch xlstm-350m --model 4 --steps 10

The flags of ``examples/train_lm.py`` (the JAX package's script) plus
``--device`` (default ``cuda``; without a GPU pass ``--device cpu``),
``--full`` (the arch's published configuration in bf16 under full remat,
with its TRAIN_OVERRIDES and a global batch of 8 x 4,096 unless
``--batch``/``--seq`` say otherwise), ``--ckpt-dir`` and ``--resume``
(continue from the latest checkpoint there) and ``--model`` (the size of the
mesh's "model" axis: tensor and expert parallelism, any arch). Under
``torchrun`` each process is one rank of a ("data", "model") mesh of
world / model by model ranks; alone it is one rank.
"""
import argparse
import datetime
import os
import sys
import tempfile

sys.path.insert(0, "src")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_reduced, get_train_overrides  # noqa: E402
from repro_torch.data.tokens import TokenDataset, TokenDatasetConfig  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.runtime.fault import StragglerMonitor  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, make_train_step, train_loop  # noqa: E402


def preset_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", vocab=32768, d_model=640, n_layers=12, n_heads=10,
        n_kv=10, d_ff=2560, pattern=("attn+mlp",), mlp_kind="swiglu",
        norm_kind="rms", remat="none",
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="olmo-1b",
                   help="reduced config of this arch (or --preset 100m, or --full)")
    p.add_argument("--preset", default=None, choices=[None, "100m"])
    p.add_argument("--full", action="store_true",
                   help="the arch's published configuration in bf16, remat full")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", type=int, default=1,
                   help='ranks on the mesh\'s "model" axis (under torchrun)')
    args = p.parse_args()
    if args.model > 1 and "WORLD_SIZE" not in os.environ:
        p.error("--model > 1 needs a torchrun launch of a multiple of that many processes")

    over = {}
    if args.preset == "100m":
        cfg = preset_100m()
    elif args.full:
        cfg = get_config(args.arch)
        over = get_train_overrides(args.arch)
    else:
        cfg = get_reduced(args.arch)
    batch = args.batch or 8
    seq = args.seq or (4096 if args.full else 64)
    lr = args.lr or (3e-4 if args.full else 3e-3)
    if args.microbatches:
        over["microbatches"] = args.microbatches

    mesh = None
    if "WORLD_SIZE" in os.environ:  # one rank of a torchrun launch
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=600))
        mesh = make_debug_mesh(n_model=args.model, device_type=args.device)
    lead = mesh is None or dist.get_rank() == 0

    model = build_model(cfg, device=args.device)
    if lead:
        print(f"model {cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params, {cfg.dtype}, "
              f"remat {cfg.remat}, on {args.device}")
    rules = default_rules(mesh)
    tcfg = TrainConfig(opt=optim.AdamWConfig(lr=lr, warmup_steps=min(10, args.steps // 4),
                                             total_steps=args.steps), **over)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                         seed=0, structure=0.9),
                      mesh=mesh, prefix_len=cfg.prefix_len, d_model=cfg.d_model,
                      frames=cfg.arch_type == "encdec", device=args.device,
                      microbatches=tcfg.row_microbatches)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep_last=2)
    params = opt_state = None
    start = 0
    if args.resume and mgr.latest_step() is not None:
        _, shardings = make_train_step(model, mesh, rules, tcfg)
        params, opt_state, start = mgr.restore_train_state(model, mesh, shardings)
        if lead:
            print(f"resumed from step {start} in {ckpt_dir}")
    mon = StragglerMonitor(threshold=3.0)

    def hook(step, params, opt_state, metrics, dt):
        mon.observe(step, dt)
        if lead and (step % 10 == 0 or step == args.steps - 1):
            print(f"  step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt * 1e3:.0f} ms")

    _, _, history = train_loop(
        model, mesh, rules, tcfg, ds, steps=args.steps, ckpt_manager=mgr,
        ckpt_every=args.ckpt_every, hooks=[hook], params=params, opt_state=opt_state,
        start_step=start,
    )
    if lead and history:
        print(f"loss: {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
        print(f"checkpoints at {ckpt_dir}: steps {mgr.all_steps()}")
        if mon.events:
            print(f"straggler events: {len(mon.events)}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
