"""Shared fixtures of the benchmark's CPU tests: tiny configurations
(genomes of 50 kb) and mixes cut to small batches, run through the
harness with device="cpu" and the caches under a temporary root."""

import pytest
import torch

from portbench import catalog


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("checkout"))


def tiny_config(families=((1,), (1,)), base="gtdb40"):
    """The configuration `base` cut to genomes of 50 kb under the tree
    `families` (species counts a genus, one list a family)."""
    fams = [list(f) for f in families]
    return dict(catalog.config(base), families=fams, genome_len=50_000,
                name="tiny" + "-".join("x".join(map(str, f)) for f in fams))


def tiny_traffic(name, **over):
    t = dict(catalog.traffic(name), warmup_batches=2, check_reads=40)
    if t["seq_mode"] == 3:
        t.update(batch=4, check_reads=6, sample_queries=12,
                 length=dict(t["length"], median=3000, min=1000, max=8000))
    else:
        t.update(batch=64, sample_queries=192)
    t.update(over)
    return t
