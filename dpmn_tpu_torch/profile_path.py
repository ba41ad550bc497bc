"""Where the time of the flagship sr_forward, or of its train step, goes on the card.

    python -m dpmn_tpu_torch.profile_path [--batch 64] [--train [--train-core {block,attention,full}] [--amp]]
    python -m dpmn_tpu_torch.profile_path [--bf16] [--glyph-from-psn] [--student-dtype bfloat16]
    python -m dpmn_tpu_torch.profile_path --arch {tsrn,tg,tpgsr,tbsrn,tatt}

Builds the flagship DPMNSystem (with --arch, the same with that PSN) with
seeded random weights, warms it up, then (1) times each stage of one real
sr_forward (the CRNN text prior of TPGSR and TATT, the PSN, each
student, each glyph render, each PGRM, CMM) with CUDA events that
forward hooks on those modules record, (2) records one forward with
torch.profiler and prints the device time of every op and kernel and the
device's busy share of the forward's wall time, and (3) prints the same
forward's wall time without the profiler.  Prints the card's name and power
limit first.

The serving modes: --bf16 profiles sr_forward_bf16 (the forward on the bf16
copy of the state; its stage modules are the copy's), --glyph-from-psn the
test() path (the students as one vmapped call, timed as one stage), and
--student-dtype bfloat16 the students on their bf16 copy.

With --train the same for one real train_step (fp32, the flagship's dropout
0.1, synthetic HR/LR): the forward stages as above plus each distill, then
the backward as a whole and the update (gradient norms, per-module clip,
Adam), timed with CUDA events around the step's own two halves
(`_train_loss`, `_loss_grads`) and `_apply_update`.  --train-core picks the
PGRMs' training attention core (kernel K3, K4 or K5; models/pgrm.py
`resolve_train_core`, which reads DPMN_TPU_FUSE_QKV / DPMN_TPU_FUSE_SKCONV
when the option is not given).  --amp profiles the bf16 AMP step
(train_dtype="bfloat16", the counterpart of tools/bench_train.py --amp):
the frozen stages are its bf16 copy's modules, the PGRMs, distills and CMM
the system's own (run on their bf16 views); the peak device memory of the
profiled step is printed with the rest.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from .config import ARCHS, TrainCfg, flagship_args
from .models.pgrm import TRAIN_CORES, resolve_train_core
from .system import DPMNSystem


def device_events(prof) -> list:
    """The device events (kernels, copies) of a torch.profiler run, without
    the annotations the profiler lays on the device timeline (ProfilerStep#,
    which spans a whole step): they are no device work."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep") and not getattr(e, "is_user_annotation", False)]


def device_busy_ms(events) -> float:
    """The device's busy time over `events`: the union of their intervals, so
    that events that overlap or that the profiler lists twice count once
    (a sum of their device times over-counts)."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def stage_modules(system: DPMNSystem, nets=None):
    """(label, module) for every stage of sr_forward that is a module call;
    `nets` holds the modules the forward runs (the system, or its bf16
    copy).  The vmapped students, where a forward has run them, are one
    stage."""
    nets = nets or system
    students = system._students(nets)
    stages = [("CRNN text prior", nets.crnn_psn)] if nets.crnn_psn is not None else []
    stages.append((f"{system.args.arch.upper()} PSN", nets.psn))
    stages += [(f"VisionLAN student {k}", s) for k, s in enumerate(students)]
    if students in system._stacks:
        stages.append(("VisionLAN students, vmapped", system._stacks[students].base))
    stages.append(("glyph render", system.glyph))
    stages += [(f"PGRM {i} ({'graphic' if p.graphic_mode else 'semantic'})", p)
               for i, p in enumerate(nets.pgrms)]
    stages += [(f"distill {i}", d) for i, d in enumerate(nets.distills)]
    stages.append(("CMM", nets.cmm))
    return stages


def hooked_stage_times(system: DPMNSystem, run, nets=None):
    """`run()` (one sr_forward or one train step) with a CUDA event recorded
    before and after each call of a stage module.  Returns [(label, calls,
    device ms)] in first-call order and run's device ms from the first to the
    last event; the rest (input copy, to_mask, argmax and EOS compaction, the
    α-blend, the losses) is the gap."""
    open_calls, spans, handles = [], [], []
    for label, mod in stage_modules(system, nets):
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
    p.add_argument("--arch", choices=ARCHS, default="tatt", help="the frozen PSN (the flagship's: tatt)")
    p.add_argument("--train", action="store_true", help="profile one train_step instead of one sr_forward")
    p.add_argument("--train-core", choices=TRAIN_CORES, default=None,
                   help="the PGRMs' training attention core (default: from DPMN_TPU_FUSE_QKV / DPMN_TPU_FUSE_SKCONV)")
    p.add_argument("--amp", action="store_true", help="with --train: the bf16 AMP step (train_dtype bfloat16)")
    p.add_argument("--bf16", action="store_true", help="profile sr_forward_bf16 (the bf16 serving forward)")
    p.add_argument("--glyph-from-psn", action="store_true",
                   help="every student reads the PSN output, as one vmapped call (the test() path)")
    p.add_argument("--student-dtype", choices=["bfloat16"], default=None, help="run the students in bf16")
    a = p.parse_args(argv)
    if a.train and (a.bf16 or a.glyph_from_psn or a.student_dtype):
        p.error("the serving modes are eval forwards: no --train with them")
    if a.amp and not a.train:
        p.error("--amp is a mode of the train step: it needs --train")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    system = DPMNSystem(TrainCfg(batch_size=a.batch), flagship_args(arch=a.arch), seed=0, train_core=a.train_core,
                        student_dtype=a.student_dtype, train_dtype="bfloat16" if a.amp else None)
    rng = np.random.RandomState(0)
    hr = rng.rand(a.batch, 32, 128, 4).astype(np.float32)
    lr = rng.rand(a.batch, 16, 64, 4).astype(np.float32)
    seeds = iter(range(10**6))
    if a.train:
        what = f"train_step (train_core {resolve_train_core(a.train_core)}{', bf16 AMP' if a.amp else ''})"
        run = lambda: system.train_step(hr, lr, next(seeds))
    else:
        forward = system.sr_forward_bf16 if a.bf16 else system.sr_forward
        what = (f"{forward.__name__}" + (" glyph_from_psn" if a.glyph_from_psn else "")
                + (f" students {a.student_dtype}" if a.student_dtype else ""))
        run = lambda: forward(lr, glyph_from_psn=a.glyph_from_psn)
    for _ in range(2):
        run()
    marks = []
    nets = system.state_bf16.get() if a.bf16 else None
    if a.amp:  # the frozen stages of the AMP step are its bf16 copy's
        frozen = system.frozen_bf16.get()
        nets = SimpleNamespace(psn=frozen.psn, crnn_psn=frozen.crnn_psn, students=frozen.students,
                               pgrms=system.pgrms, distills=system.distills, cmm=system.cmm)
    torch.cuda.reset_peak_memory_stats()
    rows, total = hooked_stage_times(
        system, (lambda: train_step_phases(system, hr, lr, next(seeds), marks)) if a.train else run, nets)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"stages of one {what} at B={a.batch} (CUDA events from forward hooks):")
    for label, calls, ms in rows:
        print(f"  {label:26s} x{calls}  {ms:9.3f} ms  {100 * ms / total:5.1f} %")
    rest = total - sum(ms for _, _, ms in rows)
    print(f"  {'outside the stage modules':26s}     {rest:9.3f} ms  {100 * rest / total:5.1f} %")
    print(f"  {what:26s}     {total:9.3f} ms; peak device memory {peak:.2f} GiB")
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
    events = device_events(prof)
    busy = device_busy_ms(events)
    print(f"profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms (the union of the device events' "
          f"intervals; their device times sum to {sum(e.device_time for e in events) / 1e3:.3f} ms), "
          f"{100 * busy / wall:.1f} % busy, {len(events)} device events")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=-1, max_name_column_width=60))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print(f"unprofiled {what}: {(time.perf_counter() - t0) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
