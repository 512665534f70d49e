"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor het_tpu, so it also runs where only
PyTorch is installed, on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_kernels.py

Without a GPU every test skips."""

import pytest
import torch

from het_tpu_torch.graph import random_heterograph
from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 3, 4, 12, 64, 68, 200])
def test_seg_sum_kernel_matches_plain(cuda, C):
    """Narrow, scalar, vector and wide payloads, with and without perm, on
    a hub-heavy graph.  Tolerance: rtol 1e-5, atol 1e-5 * max|out| (f32
    sums in another order)."""
    g = random_heterograph(num_nodes=300, num_edges=5000, num_rels=4,
                           power_law=True).to(cuda)
    info = g.compact_src
    gen = torch.Generator(device=cuda).manual_seed(C)
    vals = torch.randn(g.num_padded_edges, C, device=cuda, generator=gen)
    for ptr, perm in ((g.in_row_ptr, None),
                      (info.edge_row_ptr, info.edge_sort_perm)):
        seg_sum_sorted.launches = 0
        got = seg_sum_sorted(vals, ptr, perm)
        torch.cuda.synchronize()
        assert seg_sum_sorted.launches == 1
        want = seg_sum_sorted_plain(vals, ptr, perm)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
def test_seg_sum_kernel_is_deterministic(cuda):
    g = random_heterograph(num_nodes=200, num_edges=4000, num_rels=3,
                           power_law=True).to(cuda)
    vals = torch.randn(g.num_padded_edges, 68, device=cuda)
    a = seg_sum_sorted(vals, g.in_row_ptr)
    b = seg_sum_sorted(vals, g.in_row_ptr)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_seg_sum_rejects_cpu_index_for_cuda_values(cuda):
    vals = torch.randn(10, 4, device=cuda)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    with pytest.raises(ValueError):
        seg_sum_sorted(vals, ptr)
