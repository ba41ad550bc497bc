"""Where the time of the flagship sr_forward, or of its train step, goes on the card.

    python -m dpmn_tpu_torch.profile_path [--batch 64] [--train]

Builds the flagship DPMNSystem with seeded random weights, warms it up, then
(1) times each stage of one real sr_forward (the CRNN text prior, the TATT
PSN, each student, each glyph render, each PGRM, CMM) with CUDA events that
forward hooks on those modules record, (2) records one forward with
torch.profiler and prints the device time by kernel and the device's busy
share of the forward's wall time, and (3) prints the same forward's wall
time without the profiler.  Prints the card's name and power limit first.

With --train the same for one real train_step (fp32, the flagship's dropout
0.1, synthetic HR/LR): the forward stages as above plus each distill, then
the backward as a whole and the update (gradient norms, per-module clip,
Adam), timed with CUDA events around the step's own two halves
(`_train_loss`, `_loss_grads`) and `_apply_update`.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .config import TrainCfg, flagship_args
from .system import DPMNSystem


def stage_modules(system: DPMNSystem):
    """(label, module) for every stage of sr_forward that is a module call."""
    stages = [("CRNN text prior", system.crnn_psn), ("TATT PSN", system.psn)]
    stages += [(f"VisionLAN student {k}", s) for k, s in enumerate(system.students)]
    stages.append(("glyph render", system.glyph))
    stages += [(f"PGRM {i} ({'graphic' if p.graphic_mode else 'semantic'})", p)
               for i, p in enumerate(system.pgrms)]
    stages += [(f"distill {i}", d) for i, d in enumerate(system.distills)]
    stages.append(("CMM", system.cmm))
    return stages


def hooked_stage_times(system: DPMNSystem, run):
    """`run()` (one sr_forward or one train step) with a CUDA event recorded
    before and after each call of a stage module.  Returns [(label, calls,
    device ms)] in first-call order and run's device ms from the first to the
    last event; the rest (input copy, to_mask, argmax and EOS compaction, the
    α-blend, the losses) is the gap."""
    open_calls, spans, handles = [], [], []
    for label, mod in stage_modules(system):
        def pre(mod, args, label=label):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            open_calls.append((label, ev))

        def post(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            label, start = open_calls.pop()
            spans.append((label, start, ev))

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        first.record()
        run()
        last.record()
        torch.cuda.synchronize()
    finally:
        for hd in handles:
            hd.remove()
    rows = {}
    for label, start, end in spans:
        calls, ms = rows.get(label, (0, 0.0))
        rows[label] = (calls + 1, ms + start.elapsed_time(end))
    return [(label, calls, ms) for label, (calls, ms) in rows.items()], first.elapsed_time(last)


def train_step_phases(system: DPMNSystem, hr, lr, seed: int, marks: list):
    """One train_step as its three halves, with a CUDA event after each in
    `marks`: (label, event)."""
    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    mark("start")
    loss = system._train_loss(hr, lr, seed)
    mark("forward (PSN, students, PGRMs, distills, CMM, losses)")
    grads = system._loss_grads(loss)
    mark("backward, all trainable modules")
    system._apply_update(grads, loss.detach())
    mark("update: norms, per-module clip, Adam")


def main(argv=None):
    p = argparse.ArgumentParser(description="per-stage and per-kernel time of the flagship sr_forward or train step")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--train", action="store_true", help="profile one train_step instead of one sr_forward")
    a = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    system = DPMNSystem(TrainCfg(batch_size=a.batch), flagship_args(), seed=0)
    rng = np.random.RandomState(0)
    hr = rng.rand(a.batch, 32, 128, 4).astype(np.float32)
    lr = rng.rand(a.batch, 16, 64, 4).astype(np.float32)
    what = "train_step" if a.train else "sr_forward"
    seeds = iter(range(10**6))
    run = (lambda: system.train_step(hr, lr, next(seeds))) if a.train else (lambda: system.sr_forward(lr))
    for _ in range(2):
        run()
    marks = []
    rows, total = hooked_stage_times(
        system, (lambda: train_step_phases(system, hr, lr, next(seeds), marks)) if a.train else run)
    print(f"stages of one {what} at B={a.batch} (CUDA events from forward hooks):")
    for label, calls, ms in rows:
        print(f"  {label:26s} x{calls}  {ms:9.3f} ms  {100 * ms / total:5.1f} %")
    rest = total - sum(ms for _, _, ms in rows)
    print(f"  {'outside the stage modules':26s}     {rest:9.3f} ms  {100 * rest / total:5.1f} %")
    print(f"  {what:26s}     {total:9.3f} ms")
    if marks:
        print("the train step's halves (CUDA events):")
        for (_, start), (label, end) in zip(marks, marks[1:]):
            print(f"  {label:55s} {start.elapsed_time(end):9.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3 if events else 0.0
    print(f"profiled {what}: wall {wall:.3f} ms, device kernel time {busy:.3f} ms "
          f"({100 * busy / wall:.1f} % busy), {len(events)} device events")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=30, max_name_column_width=60))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print(f"unprofiled {what}: {(time.perf_counter() - t0) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
