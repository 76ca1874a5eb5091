"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-100m \\
      --steps 300 --batch 8 --seq 256 --ckpt-dir /tmp/run1 [--resume]

The reference's driver on one card (``--device cpu`` runs it on the
CPU):
  * resumable data pipeline + atomic async checkpoints (auto-resume): the
    `TokenStream` state rides in the checkpoint's ``extra``;
  * preemption-safe: SIGTERM triggers a final checkpoint;
  * ``--die-at-step N`` exits with 42 after step N (the recovery test's
    fault injection).

A killed-and-resumed run ends with the same weights as an uninterrupted
one, bit for bit: on the card the driver turns on torch's deterministic
algorithms and a fixed cuBLAS workspace before its first CUDA op (the
embedding's backward, for one, accumulates with atomics otherwise).
bfloat16 weights are checkpointed as their uint16 bits, which an npz
archive holds.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry as models

#: the cuBLAS workspace setting under which its products are
#: deterministic
CUBLAS_WORKSPACE = ":4096:8"


def deterministic(device: torch.device) -> None:
    """Deterministic kernels on the card; set before its first op."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.use_deterministic_algorithms(True)


def _to_disk(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint16) if t.dtype == torch.bfloat16 else t


def _from_disk(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _tree(named: dict, opt_state) -> dict:
    """The checkpoint tree: parameters by name and the optimizer state,
    bfloat16 leaves as their bits."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return _to_disk(x.detach())
    return {"params": conv(named), "opt": conv(opt_state)}


def _load(tree, named: dict, opt_state):
    """The restored numpy `tree` written into the model's parameters;
    returns the optimizer state rebuilt on their devices."""
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(_from_disk(tree["params"][k], p))

    def conv(saved, like):
        if isinstance(like, dict):
            return {k: conv(saved[k], v) for k, v in like.items()}
        if isinstance(like, (tuple, list)):
            return type(like)(conv(s, v) for s, v in zip(saved, like))
        return _from_disk(saved, like)
    return conv(tree["opt"], opt_state)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="fault-injection hook for the recovery test")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    device = torch.device(args.device)
    deterministic(device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    api = models.build(cfg)
    tc = TrainConfig(lr=args.lr, seed=args.seed)
    opt, step_fn = make_train_step(api, tc)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = api.init_params(gen, device=device)
    named = dict(model.named_parameters())
    opt_state = opt.init(named)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    t_restore = time.perf_counter()
    if mgr and args.resume:
        restored = mgr.restore(_tree(named, opt_state))
        if restored is not None:
            start_step, tree, extra = restored
            opt_state = _load(tree, named, opt_state)
            stream.load_state(extra["stream"])
            print(f"[resume] from step {start_step}")

    restore_s = time.perf_counter() - t_restore
    stop = {"flag": False}

    def _graceful(signum, frame):   # preemption: checkpoint then exit
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _graceful)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    save_s = 0.0                 # the loop's share of the checkpoints
    t_loop = time.perf_counter()
    t0 = time.time()
    step = start_step
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in stream.next_batch().items()}
        loss, gnorm, model, opt_state = step_fn(model, opt_state, batch)
        losses.append(float(loss))           # waits for the step
        times.append(time.perf_counter() - t_step)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            t_save = time.perf_counter()
            mgr.save_async(step + 1, _tree(named, opt_state),
                           extra={"stream": stream.save_state()})
            save_s += time.perf_counter() - t_save
        if args.die_at_step is not None and step + 1 == args.die_at_step:
            print("[fault-injection] simulating node failure", flush=True)
            sys.exit(42)
        if stop["flag"]:
            break
    loop_s = time.perf_counter() - t_loop
    t_final = time.perf_counter()
    if mgr:
        mgr.save(step + 1, _tree(named, opt_state),
                 extra={"stream": stream.save_state()})
        mgr.wait()
    final_save_s = time.perf_counter() - t_final
    # steady state: the median step after the first (which pays the
    # warm-up; a checkpoint's host copy lengthens its step)
    steady = sorted(times[1:] or times)
    step_s = steady[len(steady) // 2] if steady else None
    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "steps": len(losses),
              "params": model,
              "step_s": step_s,
              "tokens_per_s": (args.batch * args.seq / step_s
                               if step_s else None),
              "peak_bytes": (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None),
              "restore_s": restore_s}
    if losses:
        print(f"[done] steps={len(losses)} first={losses[0]:.4f} "
              f"final={losses[-1]:.4f}")
    if step_s:
        peak = result["peak_bytes"]
        print(f"[rate] {step_s * 1e3:.2f} ms/step (median after the first), "
              f"{result['tokens_per_s']:.1f} tokens/s; peak device memory "
              f"{'n/a' if peak is None else f'{peak / 2**30:.3f} GiB'}",
              flush=True)
    print(f"[time] set-up {t_loop - t_main - restore_s:.2f} s, restore "
          f"{restore_s:.2f} s, steps {loop_s - save_s:.2f} s, checkpoint "
          f"host copies in the loop {save_s:.2f} s, final save and wait "
          f"{final_save_s:.2f} s", flush=True)
    return result


if __name__ == "__main__":
    main()
