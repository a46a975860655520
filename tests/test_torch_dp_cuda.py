"""The path-DP CUDA kernels against their plain torch version on the
card, bit-exact, over the JAX parity grid, the block-overflow case and
the shapes where the kernels branch, the caps above 32 of a
many-species database (up to the global-scratch ring) and the long rows
and mate pairs of --seq-mode 3 and 2; each case must launch the variant
its cap selects.
No JAX import: on a machine with a card and without JAX run it as

    python -m pytest tests/test_torch_dp_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from metabuli_work_tpu_torch.ops import dp_cuda

from torch_dp_cases import (EDGES, GRID, HIGH_CAP, LONG_W, edge_case,
                            high_cap_case, overflow_case, random_case,
                            torch_blocked)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    both = (True, False)
    cases = [(random_case(np.random.default_rng(42 + s + kf), 4, 12, 9,
                          dyn_gap=dg), s, kf, dg, 8, both)
             for dg, s, kf in GRID]
    cases.append((overflow_case(), 1, 2, False, 2, both))
    for name, cap, G, W, S, kf, dg, bw, density in EDGES:
        cases.append((edge_case(name, cap, G, W, density, dg), S, kf, dg, bw,
                      both))
    for name, cap, G, W, S, kf, dg, bw, density, c5s in LONG_W:
        cases.append((edge_case(name, cap, G, W, density, dg), S, kf, dg, bw,
                      c5s))
    for name, cap, G, W, S, kf, dg, bw, density, mode in HIGH_CAP:
        cases.append((high_cap_case(name, cap, G, W, density, dg, mode), S,
                      kf, dg, bw, both))
    # the block variant's branches: more than 48 KB of shared memory at
    # cap 384, the ring in global scratch at cap 1100
    in_smem, smem, _ = dp_cuda.block_plan(384, 3)
    assert in_smem and smem > 48 * 1024
    assert not dp_cuda.block_plan(1100, 3)[0]
    for case, S, kf, dg, bw, c5s in cases:
        cap = case[0].shape[0]
        for compact5 in c5s:
            ref = torch_blocked(case, 2, 3, S, kf, dg, bw, compact5, "cuda",
                                fn=dp_cuda.path_dp_blocked_ref)
            n0, nw, nb = (dp_cuda.launches, dp_cuda.warp_launches,
                          dp_cuda.block_launches)
            got = torch_blocked(case, 2, 3, S, kf, dg, bw, compact5, "cuda")
            torch.cuda.synchronize()
            assert dp_cuda.launches == n0 + 1
            warp = cap <= dp_cuda.WARP_MAX_CAP
            assert dp_cuda.warp_launches == nw + warp
            assert dp_cuda.block_launches == nb + (not warp)
            assert ref[2] == got[2]
            np.testing.assert_array_equal(ref[0], got[0])
            np.testing.assert_array_equal(ref[1], got[1])
