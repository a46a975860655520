"""The check that decides `correct`: the plain reference against the
program's CPU run of each mix on tiny configurations, its bfloat16
control, and the timed path broken underneath a run."""

import numpy as np
import pytest

from portbench import catalog, control
from portbench import run as bench_run

from .conftest import tiny_config, tiny_traffic

# (cell, mix, changes to the mix): each cell with its own mix, and the
# single-end reads of the api mix through classify_file
CELLS = {"paired150": ("gtdb40.paired150", "paired150", {}),
         "se150": ("gtdb40.long", "api-se150", {"entry": "classify_file"}),
         "long": ("gtdb40.long", "long", {}),
         "api-se150": ("gtdb40.api-se150", "api-se150", {})}
CONFIGS = {"two families": ((1,), (1,)),
           "a genus of five": ((5, 2),),
           "three ranks": ((3, 1), (2,))}


# The timed path broken underneath a run: each wraps the program's
# Classifier._finish_complete, where a batch's records are produced.
def _alter_score(clf):
    """Every answer altered where it is produced: the score one float32
    step up."""
    orig = clf._finish_complete

    def fn(part):
        out = orig(part)
        for rec in out:
            rec.result.score = float(np.nextafter(np.float32(rec.result.score),
                                                  np.float32(2)))
        return out
    return fn


def _drop_half(clf):
    """Half of each batch left out: its second half's records replaced
    by empty (unclassified) results."""
    from metabuli_work_tpu_torch.classify.taxonomer import ReadResult

    orig = clf._finish_complete

    def fn(part):
        out = orig(part)
        for rec in out[len(out) // 2:]:
            rec.result = ReadResult()
        return out
    return fn


def _stale(clf):
    """A step that returns its state unchanged: each batch answered with
    the previous batch's results."""
    orig = clf._finish_complete
    prev = []

    def fn(part):
        out = orig(part)
        old = prev[:] or [r.result for r in out]
        prev[:] = [r.result for r in out]
        for rec, res in zip(out, old):
            rec.result = res
        return out
    return fn


FAULTS = {"alter_score": _alter_score, "drop_half": _drop_half,
          "stale": _stale}


@pytest.fixture(scope="module")
def bench():
    return catalog.benchmark()


@pytest.mark.parametrize("db", sorted(CONFIGS))
@pytest.mark.parametrize("mix", sorted(CELLS))
def test_program_equals_reference(bench, tiny_root, mix, db):
    cell, traffic, over = CELLS[mix]
    res = bench_run.run_cell(bench, cell, 20241017, 1.0, False,
                             device="cpu", root=tiny_root,
                             cfg=tiny_config(CONFIGS[db]),
                             traffic=tiny_traffic(traffic, **over))
    assert res["checks"]["mismatched_reads"]["value"] == 0
    assert res["checks"]["missing_results"]["value"] == 0
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] > 0


@pytest.mark.parametrize("mix", ["paired150", "api-se150", "long"])
def test_bfloat16_control_fails(tiny_root, mix):
    cfg = tiny_config(((3, 3),))
    got = control.control_readings(
        cfg, tiny_traffic(mix), [1, 2, 3], 300,
        bench_run.cache_root(tiny_root))
    assert min(got.values()) > 0, got


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(bench, tiny_root, fault):
    res = bench_run.run_cell(bench, "gtdb40.paired150", 7, 1.0, False,
                             device="cpu", root=tiny_root,
                             cfg=tiny_config(((3, 3),)),
                             traffic=tiny_traffic("paired150"),
                             fault=FAULTS[fault])
    assert not res["correct"]
    assert res["checks"]["mismatched_reads"]["value"] > 0


def test_mix_params_reach_program_and_reference(bench, tiny_root):
    """A mix's `params` set the program's ClassifyParams and the
    reference's scorer alike: min_cons_cnt 1 takes the host-match flow."""
    traffic = tiny_traffic("api-se150", params={"min_cons_cnt": 1})
    res = bench_run.run_cell(bench, "gtdb40.api-se150", 11, 1.0, False,
                             device="cpu", root=tiny_root,
                             cfg=tiny_config(((3, 3),)), traffic=traffic)
    assert res["correct"], res["checks"]
