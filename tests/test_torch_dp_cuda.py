"""The path-DP CUDA kernels against their plain torch version on the
card, bit-exact, over the JAX parity grid, the block-overflow case and
the shapes where the kernels branch; each case must launch the variant
its cap selects.  No JAX import: on a machine with a card and without
JAX run it as

    python -m pytest tests/test_torch_dp_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from metabuli_work_tpu_torch.ops import dp_cuda

from torch_dp_cases import (EDGES, GRID, edge_case, overflow_case,
                            random_case, torch_blocked)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(random_case(np.random.default_rng(42 + s + kf), 4, 12, 9,
                          dyn_gap=dg), s, kf, dg, 8)
             for dg, s, kf in GRID]
    cases.append((overflow_case(), 1, 2, False, 2))
    for name, cap, G, W, S, kf, dg, bw, density in EDGES:
        cases.append((edge_case(name, cap, G, W, density, dg), S, kf, dg, bw))
    for case, S, kf, dg, bw in cases:
        cap = case[0].shape[0]
        for compact5 in (True, False):
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
