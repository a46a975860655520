"""The program's own stage ranges in a traced slice, for the device-side
readers (metrics/dispatch_ops.py, metrics/*_device_ms.py).

While the profiler runs, the program's StageTimer opens a
record_function range "stage:<name>" around each of its spans
(metabuli_work_tpu_torch/utils/timing.py), and the benchmark's
RecordingTimer (trace.py) opens one more of the same name around the
program's own; the two nest, and a name nested in itself is counted once.

A device operation (kernel, copy or memset; not a range's GPU-side
annotation) belongs to the stages whose ranges hold the host op that
launched it (its linked correlation id), on that op's thread; the
innermost is its owner.  As torch's own parse of the profile does, only
a host event with no link of its own (an operator or a range) is taken
for a launcher: a CUDA runtime event (cudaLaunchKernel and the like)
links to the operator that called it, and its own id may repeat
another's.  An operation with no launch seen (the program's ctypes
kernels run from their own CUDA runtime) belongs where the linked
operation just before it on its stream belongs, since a stream runs in
launch order (the rule of trace._dp_device_seconds).

An operation is in the slice when its launch is (between the slice's
marks, on the host's clock), and counts whole: on the card's machine the
device's timestamps drift from the host's over a slice (by up to 130 ms
in 2 s, PERF.md section 5), so a window on the host's clock cannot cut
the device's timeline."""

from portbench import trace as tr


def _launches(events):
    """{correlation id of a host op with no link: (start of the op on
    the host's clock, tuple of the stage names whose ranges hold it,
    outermost first)}."""
    cpu = sorted((e for e in events if not e.device),
                 key=lambda e: (e.thread, e.start, -e.end))
    out = {}
    stack, thread = [], None
    for e in cpu:
        if e.thread != thread:
            stack, thread = [], e.thread
        while stack and stack[-1][0] <= e.start:
            stack.pop()
        chain = stack[-1][1] if stack else ()
        if e.name.startswith(tr.STAGE_PREFIX):
            name = e.name[len(tr.STAGE_PREFIX):]
            if not chain or chain[-1] != name:
                chain = chain + (name,)
            stack.append((e.end, chain))
        if e.id and not e.link:
            out[e.id] = (e.start, chain)
    return out


def device_ops(events):
    """[(device us, stages)] of each device operation launched inside
    the slice, stages as _launches gives them (() for none); None
    without the slice's marks."""
    marks = {e.name: e.start for e in events
             if e.name in (tr.MARK_START, tr.MARK_END) and not e.device}
    if tr.MARK_START not in marks or tr.MARK_END not in marks:
        return None
    w0, w1 = marks[tr.MARK_START], marks[tr.MARK_END]
    launches = _launches(events)
    ranges = (tr.DP_RANGE, tr.MARK_START, tr.MARK_END)
    dev = sorted((e for e in events if e.device and e.name not in ranges
                  and not e.name.startswith(tr.STAGE_PREFIX)),
                 key=lambda e: e.start)
    last, out = {}, []
    for e in dev:
        if e.link in launches:
            at, stages = last[e.stream] = launches[e.link]
        else:
            at, stages = last.get(e.stream, (None, ()))
        if at is not None and w0 <= at <= w1:
            out.append((e.end - e.start, stages))
    return out


def slice_ops(run):
    """device_ops of the run's traced slice (kept on the run), or None."""
    if run.slice is None or not run.slice.events:
        return None
    if getattr(run, "slice_ops", None) is None:
        run.slice_ops = device_ops(run.slice.events)
    return run.slice_ops


def slice_batches(run):
    """Batches completed inside the traced slice."""
    s = run.slice
    if s is None or s.t_start is None or s.t_end is None:
        return 0
    return sum(1 for t in run.win["batch_ends"] if s.t_start <= t <= s.t_end)


def owned_ms(run, name):
    """Device ms a batch of the operations whose innermost stage is
    `name`, over the batches completed in the slice; None when the slice
    holds no such operation."""
    ops, n = slice_ops(run), slice_batches(run)
    if not ops or not n:
        return None
    us = sum(d for d, st in ops if st and st[-1] == name)
    return us / 1e3 / n if us else None


def ops_within(run, name):
    """Device operations a batch launched inside stage `name` (or a stage
    nested in it), over the batches completed in the slice; None when
    there are none."""
    ops, n = slice_ops(run), slice_batches(run)
    if not ops or not n:
        return None
    k = sum(1 for _, st in ops if name in st)
    return k / n if k else None
