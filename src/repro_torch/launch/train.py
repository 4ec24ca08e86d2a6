"""Training entry point of the port (counterpart of ``repro.launch.train``):
token pipeline -> train step -> striped async checkpoints -> restart.

Runs on the card unless ``device="cpu"`` (``--device cpu``) is given.
A restarted run restores params and optimizer state from the latest
committed checkpoint and replays the deterministic token stream from the
restored step.  The train step runs the model's plain PyTorch versions
on purpose: no kernel of the port, nor of the reference, has a backward.

``train()`` feeds the token pipeline's batches, ``tokens`` and
``labels`` alone, as the reference's does: an encoder-decoder model
(whisper-base) fails at its first step for want of ``audio`` (KeyError;
the reference's jitted step raises a ValueError naming it), and a vision
model (phi-3-vision-4.2b) trains on text, no patch rows written (the
reference's jitted step refuses a batch without ``patches`` the same
way).  A caller with frames or patches adds them to the batch of
``launch.steps.build_cell(...).fn``.

Every config of the registry trains, the MoE family included (its loss
adds the load-balancing aux loss).  At full width (``--full``) f32
params, grads and both AdamW moments take 16 bytes a parameter on one
card: qwen3-1.7b, minicpm-2b, mamba2-130m, whisper-base and
phi-3-vision-4.2b (61 GB, the largest) fit an 80 GB card at batch 8;
llama3-8b (128 GB), gemma3-12b (188 GB) and the MoE configs
(qwen2-moe-a2.7b 229 GB, jamba-v0.1-52b 823 GB, grok-1-314b 5.1 TB) do
not on one card: they train reduced, through ``build_cell(...).fn`` on
a config cut in depth (qwen2-moe-a2.7b at 4 of its 24 layers: 46.5
GB), or over ranks.

Under torchrun or Slurm (``runtime.launcher.bootstrap``) ``train()``
trains over the host mesh, ``(world, 1)`` data × model: params and
AdamW state sharded over "data" (every rank draws the whole
initialization, keeps its slice of the params and builds the AdamW state
on that slice), each rank on its rows of the token
pipeline, checkpoints gathered to rank 0's files and restored onto any
number of ranks.  A single process runs as before, on no mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 3 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-moe-a2.7b --steps 3 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --full --steps 12 --batch 8 --seq 1024
  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train \\
      --device cpu --steps 3 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import time
from typing import List

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import build_cell
from repro_torch.models import model as M
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel.sharding import batch_spec
from repro_torch.runtime.elastic import ElasticCoordinator
from repro_torch.runtime.launcher import (bootstrap, detect_cluster,
                                          device_for)


def make_train_state(cfg, generator: torch.Generator, device, cell=None):
    """f32 params drawn from ``generator`` (which lives on ``device``) and
    a zero AdamW state.  With ``cell`` (a ``launch.steps.Cell`` over a
    mesh) the params are drawn whole, in ``init_params``' order, and cut
    to this rank's slices before the whole tree is dropped; the AdamW
    state (and the compressed sync's error feedback) is then built on the
    slices (``Cell.init_opt``), so a rank never holds more than the whole
    params and its own slices: bit for bit ``cell.shard_state`` of the
    whole state."""
    params = M.init_params(M.param_specs(cfg), generator, device=device)
    if cell is None or cell.fsdp is None:
        return params, init_opt_state(params)
    params = cell.shard_params(params)
    return params, cell.init_opt(params)


def train(arch: str, *, steps: int = 20, batch: int = 8, seq: int = 128,
          reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 10, resume: bool = True,
          fail_at_step: int | None = None, log_every: int = 1,
          opts: M.RunOptions | None = None, lr_peak: float = 1e-3,
          total_steps: int | None = None, device=None) -> List[float]:
    """Train ``arch`` for steps ``[start, steps)``, ``start`` being the
    latest checkpoint's step when ``resume`` finds one under ``ckpt_dir``
    (else 0).  Saves asynchronously every ``ckpt_every`` steps and once
    more at the end; ``fail_at_step`` raises at that step (an injected
    failure: the pending save is flushed first).  Loss, grad norm and lr
    are read from the device once per ``log_every`` steps.  Returns the
    steps' losses (over ranks: the global batch's, on every rank).

    Under torchrun or Slurm each process calls ``bootstrap`` (which opens
    the process group: NCCL on the card, gloo with ``device="cpu"``) and
    trains on its rank of the host mesh; the group is closed on return
    if ``train()`` opened it.

    Raises:
      RuntimeError: no CUDA device and ``device`` not given (the port
        runs on the card unless the caller asks for the CPU), or the
        injected failure."""
    opened = not dist.is_initialized()
    mesh, cluster = bootstrap(device=device)
    try:
        return _train(arch, mesh, device_for(cluster, device),
                      cluster.process_id == 0, steps=steps, batch=batch,
                      seq=seq, reduced=reduced, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, resume=resume,
                      fail_at_step=fail_at_step, log_every=log_every,
                      opts=opts, lr_peak=lr_peak, total_steps=total_steps)
    finally:
        if mesh is not None and opened:
            dist.destroy_process_group()


def _train(arch, mesh, dev, main_rank: bool, *, steps, batch, seq, reduced,
           ckpt_dir, ckpt_every, resume, fail_at_step, log_every, opts,
           lr_peak, total_steps) -> List[float]:
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig("custom", seq, batch, "train")
    opts = opts or M.RunOptions(q_chunk=min(seq, 512),
                                xent_chunk=min(seq, 512))
    cell = build_cell(cfg, shape, opts, mesh=mesh, lr_peak=lr_peak,
                      total_steps=total_steps or max(10 * steps, 100))
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, device=dev, mesh=mesh,
                         batch_spec=() if mesh is None else
                         batch_spec(cell.rules))
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    world = 1 if mesh is None else mesh.size
    coord = ElasticCoordinator(hosts=[f"host{i}" for i in range(world)],
                               devices_per_host=1, model_parallel=1,
                               num_pods=1)
    shardings = None if mesh is None else cell.state_shardings()

    start = 0
    params, opt = make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, cell=cell)
    if mgr and resume and mgr.latest_step() is not None:
        start, state = mgr.restore({"params": params, "opt": opt},
                                   shardings=shardings)
        params, opt = state["params"], state["opt"]
        if main_rank:
            print(f"[train] restored from step {start}")

    losses = []
    try:
        for step in range(start, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            params, opt, metrics = cell.fn(params, opt, pipe.get_batch(step))
            losses.append(metrics["loss"])
            logged = step % log_every == 0
            if logged:
                loss, gnorm, lr = (float(metrics[k]) for k in
                                   ("loss", "grad_norm", "lr"))
            dt = time.perf_counter() - t0
            coord.straggle.record("host0", dt)
            coord.hb.beat("host0")
            if logged and main_rank:
                print(f"[train] step={step} loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"lr={lr:.2e} {dt * 1e3:.0f}ms")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt},
                               shardings=shardings)
        if mgr:
            mgr.wait()
            mgr.save(steps, {"params": params, "opt": opt},
                     shardings=shardings)
    finally:
        # a failed step must not lose an in-flight async save: flush it,
        # so a restart sees the last checkpoint issued
        if mgr:
            mgr.close()
    return torch.stack(losses).tolist() if losses else []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions on the CPU)")
    args = ap.parse_args(argv)
    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, reduced=args.reduced,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   fail_at_step=args.fail_at_step, device=args.device)
    if detect_cluster().process_id != 0:
        return
    if losses:
        print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("[train] done; no step left to run")


if __name__ == "__main__":
    main()
