"""Train a small qwen3-style LM end to end on the PyTorch port: data
pipeline -> train step -> checkpointing -> restart.  The port of
examples/train_lm.py.

The default preset is CPU-sized (a ~12M-parameter model, 300 steps);
--preset full selects a ~110M model in bfloat16 for the card.  The loss
must fall below 0.75 times the first step's: asserted at the end.  A
second run with the same --ckpt-dir restarts from the latest checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_lm.py
      [--device cpu] (default: cuda) [--preset cpu|full] [--steps 300]
      [--ckpt-dir DIR] (default: repro_torch_lm_ckpt under $TMPDIR)
"""

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import LMConfig
from repro_torch.data.pipeline import LMBatchPipeline
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.trainer import TrainStep

PRESETS = {
    # ~12M params: CPU-demo scale
    "cpu": LMConfig(name="demo-12m", n_layers=4, d_model=256, n_heads=8,
                    n_kv_heads=4, d_ff=768, vocab_size=8192, d_head=32,
                    qk_norm=True, dtype="float32", vocab_pad_multiple=256),
    # ~110M params: single-accelerator scale
    "full": LMConfig(name="demo-110m", n_layers=12, d_model=768,
                     n_heads=12, n_kv_heads=4, d_ff=2304,
                     vocab_size=32768, d_head=64, qk_norm=True,
                     dtype="bfloat16", vocab_pad_multiple=256),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=PRESETS, default="cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    args = ap.parse_args()

    cfg = PRESETS[args.preset]
    dev = torch.device(args.device)
    print(f"== {cfg.name}: {cfg.n_params / 1e6:.1f}M params on {dev} ==")
    pipe = LMBatchPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, coherence=0.7)

    def loss_fn(params, batch):
        return T.train_step_loss(params, cfg, batch["tokens"],
                                 batch["labels"])

    step_fn = TrainStep(loss_fn=loss_fn, optimizer=AdamW(
        lr=cosine_schedule(3e-3, warmup=20, total=args.steps)))
    params = T.init_params(0, cfg, device=dev)
    state = step_fn.init_state(params)
    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                            keep_last=2)

    start_step, restored = mgr.restore_latest(
        {"params": params, "state": state})
    if restored is not None:
        state = restored["state"]          # the model is loaded in place
        print(f"   restored from step {start_step}")
    start_step = start_step or 0

    first_loss, loss = None, None
    t_log = time.time()
    for s in range(start_step + 1, args.steps + 1):
        tokens, labels = pipe.batch(s)
        params, state, loss = step_fn(params, state, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "labels": torch.from_numpy(labels).to(dev)})
        if first_loss is None:
            first_loss = float(loss)
        mgr.maybe_save(s, {"params": params, "state": state})
        if s % 25 == 0 or s == 1:
            dt = time.time() - t_log
            print(f"   step {s:4d} loss {float(loss):.3f} "
                  f"({dt / 25:.2f}s/step)")
            t_log = time.time()
    mgr.wait()
    if loss is None:
        print(f"== nothing to do: the checkpoint is at step {start_step} "
              f"of {args.steps} ==")
        return
    last_loss = float(loss)

    print(f"== done: loss {first_loss:.3f} -> {last_loss:.3f} "
          f"(ln V = {math.log(cfg.vocab_size):.2f}) ==")
    assert last_loss < first_loss * 0.75, "training did not learn"
    print("   checkpoints in", args.ckpt_dir, "(re-run to test restart)")


if __name__ == "__main__":
    main()
