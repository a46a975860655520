"""Multi-process runtime for classify over a global (dp, db) mesh.

The reference is a single-host tool; running one classify across
processes is a capability of this package:

  * init_distributed — torch.distributed with the gloo backend; every
    process runs the same program.
  * make_global_mesh — a (dp, db) mesh with 'dp' across processes and
    'db' within one: each process feeds and scores its own read rows,
    the index shards live on the process's own devices, and the db merge
    never crosses a process.
  * the Classifier takes the global mesh like any other: each process
    uploads only its own rows, the stats header is summed over all
    processes after every header fetch (sum_over_processes, one gloo
    all-reduce of a small CPU int64 tensor, called by every process in
    the same order), so every process takes the same retry decisions,
    and classify_file returns the process's own reads.

Nothing but that header crosses processes, so NCCL is not needed, and
two processes may share one card (NCCL refuses two ranks on a device).

CPU test recipe (tests/test_torch_distributed.py): two processes, each
with two CPU cells, tcp://localhost:<free port>; their merged records
equal a single-process run.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharding import Mesh, visible_cards


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join the process group (gloo).  coordinator_address is
    "host:port"; the arguments default to MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK.  Call once per process; returns (rank, world
    size)."""
    env = os.environ
    try:
        if coordinator_address is None:
            coordinator_address = \
                f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = int(num_processes if num_processes is not None
                    else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"init_distributed: pass the argument or set {e}") \
            from e
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return rank, world


def make_global_mesh(dp_per_process: int = 1, local_devices=None):
    """(dp, db) mesh over all processes: dp rows = processes x
    dp_per_process (rounded down to a divisor of the local device
    count), db = the remaining local devices.  local_devices defaults to
    this process's visible cards; every process must bring as many.
    Rows of other processes hold None."""
    rank, world = (dist.get_rank(), dist.get_world_size()) \
        if dist.is_initialized() else (0, 1)
    devs = visible_cards() if local_devices is None \
        else [resolve_device(d) for d in local_devices]
    per = len(devs)
    dp_local = max(1, min(dp_per_process, per))
    while per % dp_local:
        dp_local -= 1
    db = per // dp_local
    grid = np.empty((world * dp_local, db), dtype=object)
    rows = list(range(rank * dp_local, (rank + 1) * dp_local))
    for k, i in enumerate(rows):
        grid[i] = devs[k * db:(k + 1) * db]
    return Mesh(grid, local_rows=rows)


def process_local_rows(mesh) -> list:
    """Global 'dp' rows whose cells belong to this process."""
    return list(mesh.local_rows)


def sum_over_processes(a):
    """Element-wise sum of an int64 array over all processes: one
    all-reduce of a CPU tensor over the default (gloo) group."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def merge_process_results(local_records: dict, out_path: str):
    """Write this process's per-read records as JSON (one file per
    process); the launcher merges them, off the collective path."""
    with open(out_path, "w") as f:
        json.dump(local_records, f)
