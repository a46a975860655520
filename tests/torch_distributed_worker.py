"""Subprocess worker of tests/test_torch_distributed.py (imports torch
and the torch package only).

Usage: python torch_distributed_worker.py <port> <rank> <nproc> <db_dir>
       <reads> <out_json> <local_cells> [<seq_mode>]

Each process joins the gloo process group at localhost:<port>, builds
the global mesh (dp = processes, db = local_cells CPU cells), classifies
the SAME reads file through the mesh path (--seq-mode 1 unless given)
and writes the records of its OWN reads as JSON; the launcher merges
them.  Its last line counts the reads it redid from chunks (those beyond
the long-read row cap).
"""

import sys


def main():
    port, rank, nproc, db_dir, reads, out_json, cells = sys.argv[1:8]
    seq_mode = int(sys.argv[8]) if len(sys.argv) > 8 else 1
    import numpy as np

    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.parallel.distributed import (
        init_distributed, make_global_mesh, merge_process_results,
        process_local_rows)

    init_distributed(f"localhost:{port}", int(nproc), int(rank))
    mesh = make_global_mesh(local_devices=["cpu"] * int(cells))
    assert mesh.shape == {"dp": int(nproc), "db": int(cells)}
    assert process_local_rows(mesh) == [int(rank)] and mesh.multi_process
    params = ClassifyParams(seq_mode=seq_mode, min_score=0.15,
                            min_sp_score=0.5, batch_size=8)
    clf = Classifier(db_dir, params, mesh=mesh)
    records = {}
    for q in clf.classify_file(reads):
        r = q.result
        records[q.name] = [bool(r.is_classified), int(r.classification),
                           int(np.float32(r.score).view(np.int32)),
                           {str(k): v for k, v in r.tax_cnt.items()}]
    merge_process_results(records, out_json)
    print(f"process {rank}: {len(records)} reads, "
          f"{clf.timer.counts['retry']} retries, "
          f"{clf.timer.counts['long_score']} long reads", flush=True)


if __name__ == "__main__":
    main()
