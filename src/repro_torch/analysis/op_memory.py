"""The card's memory held inside single aten ops: what a fake-mode
estimate cannot see.

MemTracker (and so the dry run's fake-mode estimate) reads the tensors
alive between ops; a fake op allocates only its outputs.  A CUDA op may
allocate a workspace and free it before it returns, and then the card
peaks inside the op.  `OpWorkspace` runs each op under a dispatch mode
below the dry run's counters and reads the allocator's peak around it:
`peak - max(before, after)` is what the op held inside itself.

    python -m repro_torch.analysis.op_memory --arch stablelm-12b \\
        --shape train_4k

runs one dry-run cell as rank 0 of a fake (16, 16) group on the card and
prints the op at the process's peak and the ops that held the most
inside themselves.  The allocator's peak is reset before every op, so
the cell's own `max_memory_allocated` is not read here.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GIB = 2 ** 30


class OpWorkspace(TorchDispatchMode):
    """Per op on the card: (held inside, op, input shapes, before, peak,
    after), bytes; `top` the row at the highest peak."""

    def __init__(self):
        super().__init__()
        self.rows, self.top = [], None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = func(*args, **(kwargs or {}))
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        shapes = tuple((tuple(a.shape), str(a.dtype).removeprefix("torch."))
                       for a in args if isinstance(a, torch.Tensor))
        row = (peak - max(before, after), str(func), shapes, before, peak,
               after)
        self.rows.append(row)
        if self.top is None or peak > self.top[4]:
            self.top = row
        return res

    def by_op(self, n: int = 10):
        """The n (op, shapes) that held the most inside one call: (op,
        shapes, calls, the most held)."""
        agg = {}
        for held, op, shapes, *_ in self.rows:
            a = agg.setdefault((op, shapes), [0, 0])
            a[0] += 1
            a[1] = max(a[1], held)
        return sorted(((op, sh, c, h) for (op, sh), (c, h) in agg.items()),
                      key=lambda r: -r[3])[:n]


def main(argv=None):
    from repro_torch.launch import dryrun
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="stablelm-12b")
    p.add_argument("--shape", default="train_4k")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("op_memory reads the card's allocator: no card")
    ws = OpWorkspace()
    with ws:
        r = dryrun.run_cell(a.arch, a.shape, False, device="cuda",
                            verbose=False)
    held, op, shapes, before, peak, after = ws.top
    print(f"{a.arch} {a.shape}, rank 0 of (16, 16), {len(ws.rows)} ops | "
          f"MemTracker on the card {r['memory_peak_bytes'] / GIB:.3f} GiB "
          f"| the process's peak {peak / GIB:.3f} GiB inside {op} "
          f"{shapes}: {before / GIB:.3f} GiB before, {after / GIB:.3f} "
          f"after, {held / GIB:.4f} held inside")
    for op, shapes, calls, most in ws.by_op():
        print(f"  {most / GIB:8.4f} GiB inside, {calls:5d} calls  {op} "
              f"{shapes}")
    print(f"  {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
