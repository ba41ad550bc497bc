"""Where the time of the flagship sr_forward goes on the card.

    python -m dpmn_tpu_torch.profile_path [--batch 64]

Builds the flagship DPMNSystem with seeded random weights, warms it up, then
(1) times each stage of one real sr_forward (the CRNN text prior, the TATT
PSN, each student, each glyph render, each PGRM, CMM) with CUDA events that
forward hooks on those modules record, (2) records one forward with
torch.profiler and prints the device time by kernel and the device's busy
share of the forward's wall time, and (3) prints the same forward's wall
time without the profiler.  Prints the card's name and power limit first.
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
    stages.append(("CMM", system.cmm))
    return stages


def hooked_stage_times(system: DPMNSystem, lr: np.ndarray):
    """One sr_forward with a CUDA event recorded before and after each call of
    a stage module.  Returns [(label, calls, device ms)] in first-call order
    and the forward's device ms from the first to the last event; the rest
    (input copy, to_mask, argmax and EOS compaction, the α-blend) is the gap."""
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
        system.sr_forward(lr)
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


def main(argv=None):
    p = argparse.ArgumentParser(description="per-stage and per-kernel time of the flagship sr_forward")
    p.add_argument("--batch", type=int, default=64)
    a = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    system = DPMNSystem(TrainCfg(batch_size=a.batch), flagship_args(), seed=0)
    lr = np.random.RandomState(0).rand(a.batch, 16, 64, 4).astype(np.float32)
    for _ in range(2):
        system.sr_forward(lr)
    rows, total = hooked_stage_times(system, lr)
    print(f"stages of one sr_forward at B={a.batch} (CUDA events from forward hooks):")
    for label, calls, ms in rows:
        print(f"  {label:26s} x{calls}  {ms:9.3f} ms  {100 * ms / total:5.1f} %")
    rest = total - sum(ms for _, _, ms in rows)
    print(f"  {'outside the stage modules':26s}     {rest:9.3f} ms  {100 * rest / total:5.1f} %")
    print(f"  {'forward':26s}     {total:9.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.sr_forward(lr)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3 if events else 0.0
    print(f"profiled forward: wall {wall:.3f} ms, device kernel time {busy:.3f} ms "
          f"({100 * busy / wall:.1f} % busy), {len(events)} device events")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=25, max_name_column_width=60))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.sr_forward(lr)
    torch.cuda.synchronize()
    print(f"unprofiled forward: {(time.perf_counter() - t0) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
